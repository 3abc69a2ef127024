"""K4's plain PyTorch version against the JAX package's region solvers.

The contract is bitwise identity with ``pallas_small_mwvc`` (run in
interpret mode on the CPU, as its own tests run it) at n = 16 and 20, and
with the enumeration kernel ``batched_small_mwvc`` at n = 16: the same
minimum cost, and the same smallest cover bitmask among the minima.
"""

import numpy as np
import pytest
import torch

from gnn_mwvc_tpu.ops.smallsolve import batched_small_mwvc
from gnn_mwvc_tpu.ops.smallsolve_pallas import pallas_small_mwvc
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (small_mwvc_mitm,
                                                    small_mwvc_mitm_plain)


def _pack(instances, n):
    """[(weights, edges)] -> (adj, w) (B, n) int32; (i, i) is a self-loop."""
    adj = np.zeros((len(instances), n), np.int32)
    w = np.zeros((len(instances), n), np.int32)
    for k, (wts, edges) in enumerate(instances):
        w[k, :len(wts)] = wts
        for i, j in edges:
            adj[k, i] |= 1 << j
            adj[k, j] |= 1 << i
    return adj, w


def _random(rng, b, n, wmax=1000, forced=False, full=False):
    out = []
    for _ in range(b):
        k = n if full else int(rng.integers(1, n + 1))
        wts = rng.integers(1, wmax + 1, size=k).tolist()
        pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
        sel = rng.choice(len(pairs), size=int(rng.integers(0, min(
            len(pairs), 3 * k) + 1)), replace=False) if pairs else []
        edges = [pairs[i] for i in sel]
        if forced:
            edges += [(i, i) for i in range(k) if rng.random() < 0.2]
        out.append((wts, edges))
    return out


def _cross_half(rng, b, n):
    # every edge spans the low-7 / high split: exercises the cross mask
    out = []
    for _ in range(b):
        edges = sorted({(int(rng.integers(0, 7)), int(rng.integers(7, n)))
                        for _ in range(12)})
        out.append((rng.integers(1, 50, size=n).tolist(), edges))
    return out


def _structured(rng, b, n):
    return [
        ([5], []),                                          # isolated vertex
        ([3, 4], [(0, 1)]),                                 # single edge
        ([1] * n, [(i, (i + 1) % n) for i in range(n)]),    # n-cycle
        ([10] * n, [(i, j) for i in range(n) for j in range(i + 1, n)]),
        ([7, 1, 1, 1, 1, 1], [(0, k) for k in range(1, 6)]),  # star
        ([2, 2, 2], []),                                    # empty cover
        ([0, 0, 4], [(0, 1)]),                              # zero weights
    ]


CASES = {
    "random": lambda rng, b, n: _random(rng, b, n),
    "tie_heavy": lambda rng, b, n: _random(rng, b, n, wmax=1),
    "forced": lambda rng, b, n: _random(rng, b, n, wmax=50, forced=True,
                                        full=True),
    "cross_half": _cross_half,
    "padded": lambda rng, b, n: _random(rng, b, n)[:b - 3] + [([], [])] * 3,
    "structured": _structured,
}


def _plain(adj, w):
    c, s = small_mwvc_mitm_plain(torch.from_numpy(adj), torch.from_numpy(w))
    return c.numpy(), s.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_n16_matches_pallas_and_enumeration(case):
    rng = np.random.default_rng(sorted(CASES).index(case) + 7)
    adj, w = _pack(CASES[case](rng, 29, 16), 16)
    c, s = _plain(adj, w)
    c0, s0 = batched_small_mwvc(adj, w)
    c1, s1 = pallas_small_mwvc(adj, w, interpret=True)
    np.testing.assert_array_equal(c, np.asarray(c0))
    np.testing.assert_array_equal(s, np.asarray(s0))
    np.testing.assert_array_equal(c, np.asarray(c1))
    np.testing.assert_array_equal(s, np.asarray(s1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_n20_matches_pallas(case):
    rng = np.random.default_rng(sorted(CASES).index(case) + 31)
    adj, w = _pack(CASES[case](rng, 8, 20), 20)
    c, s = _plain(adj, w)
    c1, s1 = pallas_small_mwvc(adj, w, interpret=True)
    np.testing.assert_array_equal(c, np.asarray(c1))
    np.testing.assert_array_equal(s, np.asarray(s1))


def test_wrapper_routes_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(3)
    adj, w = _pack(_random(rng, 5, 16), 16)
    before = _build.launches["small_mwvc_mitm"]
    c, s = small_mwvc_mitm(torch.from_numpy(adj), torch.from_numpy(w))
    assert _build.launches["small_mwvc_mitm"] == before  # no kernel launch
    c0, s0 = _plain(adj, w)
    np.testing.assert_array_equal(c.numpy(), c0)
    np.testing.assert_array_equal(s.numpy(), s0)


@pytest.mark.parametrize("bad", ["width", "dtype", "shape"])
def test_wrapper_rejects_bad_inputs(bad):
    adj = torch.zeros(4, 16, dtype=torch.int32)
    w = torch.zeros(4, 16, dtype=torch.int32)
    if bad == "width":
        adj, w = adj[:, :12].contiguous(), w[:, :12].contiguous()
    elif bad == "dtype":
        w = w.long()
    else:
        w = w[:3]
    with pytest.raises(ValueError):
        small_mwvc_mitm(adj, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_enumeration_equals_jax_and_k4_plain(case):
    """The port's 2^16-subset enumeration (the oracle K4 is held against
    on the card) against the JAX enumeration and K4's plain version."""
    from gnn_mwvc_tpu.ops.smallsolve import pack_instances as jax_pack
    from gnn_mwvc_tpu_torch.ops.smallsolve import (batched_small_mwvc as
                                                   torch_enumeration,
                                                   pack_instances)

    rng = np.random.default_rng(sorted(CASES).index(case) + 53)
    instances = CASES[case](rng, 23, 16)
    adj, w = _pack(instances, 16)
    if case != "forced":  # pack_instances has no self-loop convention
        loopless = [(wts, [e for e in edges if e[0] != e[1]])
                    for wts, edges in instances]
        for a, b in zip(pack_instances(loopless), jax_pack(loopless)):
            np.testing.assert_array_equal(a, b)
    c, s = torch_enumeration(torch.from_numpy(adj), torch.from_numpy(w))
    assert c.dtype == s.dtype == torch.int32
    c0, s0 = batched_small_mwvc(adj, w)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c0))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s0))
    c1, s1 = _plain(adj, w)
    np.testing.assert_array_equal(c.numpy(), c1)
    np.testing.assert_array_equal(s.numpy(), s1)


def test_torch_enumeration_chunks_and_rejects_bad_shapes():
    from gnn_mwvc_tpu_torch.ops import smallsolve

    rng = np.random.default_rng(61)
    adj, w = _pack(_random(rng, 300, 16), 16)   # more than one chunk
    c, s = smallsolve.batched_small_mwvc(torch.from_numpy(adj),
                                         torch.from_numpy(w))
    c1, s1 = _plain(adj, w)
    np.testing.assert_array_equal(c.numpy(), c1)
    np.testing.assert_array_equal(s.numpy(), s1)
    with pytest.raises(ValueError):
        smallsolve.batched_small_mwvc(torch.zeros(2, 20, dtype=torch.int32),
                                      torch.zeros(2, 20, dtype=torch.int32))
