"""Cells that drive the command line ``gnn-vc-torch`` with a time budget:
one call a window, whose ``[time]`` is the window's seconds, so that phase 2
(the local search and the device assist's K4 region batches) runs from the
command line, over the file's own vertex ids.

Traffic keys: ``instance`` and ``warmup`` as in ``cli.py``, ``warmup``'s
``time`` being the warm-up call's budget; ``args`` (the command line, with
``{graph}``, ``{result}`` and ``{time}`` filled in and the value of
``--device`` set to the run's device); ``solve``: the command line's assist
settings (``assist_batch``, ``assist_rmax``), as data for the K4 reader;
``check``: the rounds whose scores the reference recomputes, as in
``cli.py``, and the K4 batches it re-solves, as in ``solve.py``; ``limits``.
A ``side`` set on a geometric configuration sizes it (``_sized``).

The set-up writes the instance as a METIS file and warms up
(``cli.prepare``).  The window is ``cli.window``'s closed loop, with
``cli.SnapshotProbe`` around each per-snapshot scoring and
``solve.RegionProbe`` around each region batch.  The judge (``cli.judge``)
checks the written cover against the benchmark's own CSR, its cost against
the ``--json`` line's, the drawn rounds' scores against
``reference/gnn.py`` and the kept K4 batches by exhaustive enumeration
(``reference/regions.py``).
"""

from __future__ import annotations

import numpy as np

from perfbench.entries import cli
from perfbench.entries import solve as solve_entry

__all__ = ["CONTROLS", "prepare", "window", "release", "judge", "attempts",
           "counters"]

CONTROLS = cli.CONTROLS


def _timed(traffic, seconds):
    """``traffic`` with the command line's ``{time}`` set to ``seconds``."""
    args = [a.replace("{time}", f"{seconds:g}") for a in traffic["args"]]
    return {**traffic, "args": args}


def _sized(config):
    """``config`` with a ``side`` (a road configuration's size key, which a
    caller may set on every cell for a short run) taken, on a geometric
    configuration, as about side^2 points: ``log2_n`` becomes the largest
    power of two not above it, so that a short budget still reaches
    phase 2."""
    family = config["family"].split(":")[0].strip()
    if "side" in config and family == "geometric":
        return {**config, "log2_n": (config["side"] ** 2).bit_length() - 1}
    return config


def prepare(config, traffic, seed, seconds, device):
    config = _sized(config)
    state = cli.prepare(config, _timed(traffic, traffic["warmup"]["time"]),
                        seed, seconds, device)
    chk = traffic["check"]
    rng = np.random.default_rng([seed, 1])  # apart from the rounds' draw
    # the command line's assist is on for a card: every window has batches
    # to judge, and one without them fails (``solve.judge``)
    state.update(traffic=_timed(traffic, seconds),
                 kwargs={"device_assist": True}, region_rng=rng,
                 keep_batches=[0] + sorted(rng.integers(
                     1, chk["batch_range"], size=chk["batches"] - 1).tolist()))
    return state


def window(state, seconds, span):
    """``cli.window`` with each region batch through ``solve.RegionProbe``:
    its closed loop makes one call, which the budget keeps going past the
    window's end."""
    from gnn_mwvc_tpu_torch.solver import device_assist

    regions = solve_entry.RegionProbe(device_assist.small_mwvc_mitm,
                                      state["keep_batches"])
    state["regions"] = regions
    device_assist.small_mwvc_mitm = regions
    try:
        cli.window(state, seconds, span)
    finally:
        device_assist.small_mwvc_mitm = regions.inner


release = solve_entry.release
judge = cli.judge
attempts = solve_entry.attempts
counters = cli.counters
