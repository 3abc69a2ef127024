"""The port's phase-2 device assist on the CPU (K4's plain version): a
region batch round-trips, its exact solves patch improvements back, and
the cover stays valid."""

import numpy as np
import pytest

from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.solver.device_assist import DeviceAssist
from tests.conftest import random_graph


@pytest.mark.parametrize("rmax", [14, 20])
def test_assist_round_trip_patches_an_all_in_cover(rmax):
    g = random_graph(600, 6, seed=9, wmax=80)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    cost0 = ls.cost
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device="cpu",
                          batch=16, rmax=rmax)
    assert assist.tick(ls) == 0          # dispatch only
    applied = assist.tick(ls)            # collect (CPU: already solved)
    assist.stop()
    assert assist.stats["batches"] == 1
    assert applied == assist.stats["patches"] >= 1
    assert assist.stats["gain"] == cost0 - ls.cost > 0
    cur = ls.current().astype(bool)
    e = g.edge_array()
    assert (cur[e[:, 0]] | cur[e[:, 1]]).all()


def test_centre_pool_is_seeded_and_prefers_misfits():
    g = random_graph(500, 6, seed=3, wmax=50)
    prob = np.full(g.n, 0.99, np.float32)
    prob[:50] = 0.0                      # strong misfits while in the cover
    pools = []
    for _ in range(2):
        ls = CoreLocalSearch(g.weights, g.edge_array(),
                             np.ones(g.n, np.uint8))
        a = DeviceAssist(prob, device="cpu", batch=8, pool_mult=4, seed=5)
        a._refill_pool(ls)
        pools.append(a._pool.copy())
    np.testing.assert_array_equal(pools[0], pools[1])
    cover = ls.current().astype(bool)
    assert cover[pools[0]].all()         # centres are cover vertices
    share = cover[:50].sum() / cover.sum()  # the misfits' share of the cover
    assert (pools[0] < 50).mean() > 3 * share
