"""The ``cli_budget`` entry (``rgg19-s42.budget-cli``) in a whole run on the
CPU at a small size: a sound run is ``correct`` and its budget readers read
the entry's counters; the TF32 control and each fault the cell can have,
planted in the program underneath the run, are not ``correct``.

The command line has no option for the assist's batch, so the runs here
give ``solve``'s defaults a 64 x 16 batch (K4's plain version solves a
1024 x 20 batch in seconds on the CPU); its ``--device-assist`` turns the
assist on, as a card's ``auto`` does."""

import functools
import json

import numpy as np
import pytest
import torch

from perfbench.run import load_module, run_cell

CELL = "rgg19-s42.budget-cli"
OVER = {"args": ["{graph}", "{result}", "{time}", "-1", "0", "--json",
                 "--device", "cuda", "--device-assist"],
        "warmup": {"log2_n": 10, "time": 0.5},
        "check": {"rounds": 2, "round_range": 8, "batches": 3,
                  "batch_range": 6, "regions_per_batch": 32}}
COUNTER_READERS = ["cost_excess_ppm", "ls_steps_per_s", "search_share",
                   "assist_host_share", "assist_sample_share",
                   "assist_extract_share", "assist_apply_share",
                   "assist_dispatch_share", "handoff_s.budget",
                   "phase2_fall_ppm"]


@pytest.fixture(autouse=True)
def small_batches(monkeypatch):
    from gnn_mwvc_tpu_torch.solver import pipeline

    monkeypatch.setattr(pipeline, "solve", functools.partial(
        pipeline.solve, assist_batch=64, assist_rmax=16))


def run(trace=False, control=False):
    return run_cell(CELL, 2**31 + 29, 2.0, trace, device="cpu",
                    scale={"log2_n": 13}, traffic_over=OVER, control=control)


def test_sound_run_is_correct_and_the_control_is_not():
    out = run(trace=True, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["checks"]["k4_wrong"]["value"] == 0
    assert not out["control"]["tf32"]["correct"]
    assert out["control"]["tf32"]["checks"]["score_gap"]["value"] > 5e-4
    # the budget cells' readers read this entry's counters unedited
    assert set(COUNTER_READERS) - {"cost_excess_ppm"} <= set(out["metrics"])


def _ctx(phase1=None, cost=None, best_gain=30):
    """The entry's counters (``cli.counters``) of one call whose phase 2
    started at a cover of 1,100 and wrote one of 1,000."""
    solve = {"seconds": 51.5, "cost": 1000 if cost is None else cost,
             "yardstick": 990,
             "phase1": {"phase2_start_cost": 1100, "spans": {}}
             if phase1 is None else phase1,
             "time_gnn": 12.0, "ls_steps": 10**6,
             "assist": {"gain": 4 * best_gain, "best_gain": best_gain,
                        "t_host_s": 20.0},
             "cli_spans": {"read": {"seconds": 0.4, "calls": 1}},
             "n": 10, "m": 20}
    return {"counters": {"solves": [solve], "regions_checked": 64}}


def test_assist_gain_share_reads_the_entrys_counters():
    read = load_module("metrics", "assist_gain_share").read
    assert read(_ctx()) == pytest.approx(30.0)
    # a program without the counters, a phase 2 that gained nothing, a
    # solve without the assist: nothing, never 0
    assert read(_ctx(phase1={"spans": {}})) is None
    c = _ctx()
    del c["counters"]["solves"][0]["assist"]["best_gain"]
    assert read(c) is None
    assert read(_ctx(cost=1100)) is None
    c = _ctx()
    c["counters"]["solves"][0]["assist"] = None
    assert read(c) is None
    assert read({"counters": {"solves": []}}) is None


def test_phase2_fall_ppm_reads_the_entrys_counters():
    read = load_module("metrics", "phase2_fall_ppm").read
    assert read(_ctx()) == pytest.approx(100 / 990 * 1e6)
    # a program without the counter, a cover the reference did not judge
    assert read(_ctx(phase1={"spans": {}})) is None
    c = _ctx()
    c["counters"]["solves"][0]["cost"] = None
    assert read(c) is None
    assert read({"counters": {"solves": []}}) is None


def test_a_run_reads_assist_gain_share():
    """The whole run's counters through the readers: the start cost is the
    program's, the written cost the reference's."""
    out = run(trace=True)
    assert out["correct"], out["checks"]
    assert 0 <= out["metrics"]["assist_gain_share"]["value"] <= 100
    assert out["metrics"]["phase2_fall_ppm"]["value"] >= 0


@pytest.mark.parametrize("cell", ["road700.budget", "road700.budget-plain"])
def test_the_road_budget_cells_read_phase2_fall_ppm(cell):
    """The counter reaches ``phase2_fall_ppm`` (and, with the assist,
    ``assist_gain_share``) through the ``solve`` entry too."""
    over = {"warmup": {"side": 24, "time_limit": 0.3, "scorer_args": {}},
            "check": {"rounds": 2, "round_range": 8, "batches": 3,
                      "batch_range": 6, "regions_per_batch": 32}}
    if cell == "road700.budget":
        over["solve"] = {"reorder": True, "device_assist": True,
                         "assist_batch": 64, "assist_rmax": 12}
    out = run_cell(cell, 2**31 + 11, 2.0, True, device="cpu",
                   scale={"side": 60}, traffic_over=over)
    assert out["correct"], out["checks"]
    assert out["metrics"]["phase2_fall_ppm"]["value"] >= 0
    if cell == "road700.budget":
        assert 0 <= out["metrics"]["assist_gain_share"]["value"] <= 100


def test_a_side_sizes_the_geometric_instance():
    """The short run every cell gets (``side``, a road size key) reaches
    phase 2 here too: ``side`` 300 is 2^16 points, about 90,000."""
    from perfbench.entries.cli_budget import _sized

    geo = {"family": "geometric: points", "log2_n": 19}
    assert _sized({**geo, "side": 300})["log2_n"] == 16
    assert _sized({**geo, "side": 64})["log2_n"] == 12
    assert _sized(geo) == geo
    road = {"family": "road: a grid", "side": 300}
    assert _sized(road) == road
    out = run_cell(CELL, 2**31 + 7, 2.0, False, device="cpu",
                   scale={"side": 64}, traffic_over=OVER)
    assert out["correct"], out["checks"]
    assert out["checks"]["k4_wrong"]["value"] == 0


def _flip_first_bit(monkeypatch):
    from gnn_mwvc_tpu_torch import graphio

    real = graphio.write_solution

    def flipped(path, sol):
        sol = np.array(sol, copy=True)
        sol[0] = 1 - sol[0]
        real(path, sol)

    monkeypatch.setattr(graphio, "write_solution", flipped)
    return ("cost_gap", 0)


def _all_in_regions(monkeypatch):
    from gnn_mwvc_tpu_torch.solver import device_assist

    real = device_assist.small_mwvc_mitm

    def all_in(adj, w):
        real(adj, w)
        used = (w != 0) | (adj != 0)
        bits = (used.to(torch.int32)
                << torch.arange(adj.shape[1], dtype=torch.int32)).sum(
                    1, dtype=torch.int32)
        return w.sum(1, dtype=torch.int32), bits

    monkeypatch.setattr(device_assist, "small_mwvc_mitm", all_in)
    return ("k4_wrong", 0)


def _tf32_products(monkeypatch):
    from perfbench.reference.gnn import _tf32

    def linear(self, x):
        return torch.nn.functional.linear(_tf32(x), _tf32(self.weight),
                                          self.bias)

    monkeypatch.setattr(torch.nn.Linear, "forward", linear)
    return ("score_gap", 5e-4)


def _json_cost_off_by_one(monkeypatch):
    from gnn_mwvc_tpu_torch.solver import cli

    class OffByOne:
        @staticmethod
        def dumps(obj, **kw):
            if isinstance(obj, dict) and "cost" in obj:
                obj = {**obj, "cost": obj["cost"] + 1}
            return json.dumps(obj, **kw)

    monkeypatch.setattr(cli, "json", OffByOne)
    return ("cost_gap", 0)


FAULTS = {"flipped_cover_bit": _flip_first_bit,
          "wrong_k4_answer": _all_in_regions,
          "tf32_scores": _tf32_products,
          "json_cost_off_by_one": _json_cost_off_by_one}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_caught(monkeypatch, fault):
    check, above = FAULTS[fault](monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]
    assert out["checks"][check]["value"] > above, out["checks"]
