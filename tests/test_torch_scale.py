"""The full-size studies' tooling and what they showed, on the CPU at a
small size.

The canonical tools of both packages run road60 for 1 s with the device
assist, as the 1000 s runs on road1200 and road1600 run with it on the card:
each record carries every field the comparison of the two packages reads,
and the port's written cover is valid at its stated cost.  ``tools/watch``,
which samples a study's memory while it runs, passes the command's output
and exit code through.

Repaired: the full training-quality study aborted on the card ("stack
smashing detected") in the assist of a held-out ER graph.  The JAX
package's core keeps the vertices a patch flips in a stack buffer of 16,
and a width-20 region's assignment can flip up to 20.  The port's own copy
of the core holds 32, so the assist offers every improving patch.
"""

import json
import sys

import numpy as np
import pytest

import tools.canonical as jax_canonical
from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.solver.device_assist import DeviceAssist
from gnn_mwvc_tpu_torch.tools import canonical, watch

COMPARED = ("written", "best", "ls_steps")
COMPARED_ASSIST = ("batches", "patches", "gain", "t_host_s")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_canonical_record_has_the_compared_fields(package, tmp_path, capsys,
                                                  monkeypatch):
    argv = ["road60", "--time", "1", "--seed", "2", "--device-assist",
            "--out", str(tmp_path / "c.json")]
    results = []
    if package == "jax":
        jax_canonical.main([*argv, "--no-probe"])
    else:
        def solve_and_keep(*args, **kwargs):
            results.append(port_solve(*args, **kwargs))
            return results[-1]

        port_solve = canonical.solve
        monkeypatch.setattr(canonical, "solve", solve_and_keep)
        assert canonical.main([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    with open(tmp_path / "c.json") as f:
        assert json.load(f) == rec
    assert lines[-2] == (f"road60,{rec['written']},{rec['best']},"
                         f"{rec['t_best']:.1f}")
    for k in COMPARED:
        assert isinstance(rec[k], int), k
    assert 0 < rec["best"] <= rec["written"] and rec["ls_steps"] > 0
    assert rec["device_assist"] is True and rec["seed"] == 2
    for k in COMPARED_ASSIST:
        assert isinstance(rec["assist"][k], (int, float)), k
        assert rec["assist"][k] >= 0, k
    if package == "jax":
        return
    (res,) = results
    g = build_road_graph(60)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == rec["written"] == res.cost
    assert "kernel_edges_uncovered" in rec["scorer"]
    (run,) = [json.loads(ln[len("run: "):]) for ln in lines
              if ln.startswith("run: ")]
    assert run == {"kernel_size": res.kernel_size,
                   "peak_device_bytes": None}     # no card: the CPU run
    assert res.kernel_size > 0


@pytest.mark.parametrize("code", [0, 3])
def test_watch_samples_memory_and_passes_the_exit_code(code, tmp_path,
                                                       capsys):
    out, log = tmp_path / "w.json", tmp_path / "w.log"
    child = ("import time; x = bytearray(64 << 20); print('grown', "
             f"flush=True); time.sleep(0.6); raise SystemExit({code})")
    rc = watch.main(["--every", "0.1", "--out", str(out), "--log", str(log),
                     "--", sys.executable, "-c", child])
    assert rc == code
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    with open(out) as f:
        assert json.load(f) == rec
    assert lines[0] == "card: none" and "grown" in lines
    assert log.read_text() == "grown\n"
    assert rec["rc"] == code and rec["command"][-1] == child
    assert rec["card"] is None and rec["peak_card_mib"] is None
    assert len(rec["samples"]) >= 3
    assert all(s[2] is None for s in rec["samples"])
    assert rec["peak_rss_bytes"] >= 64 << 20
    assert [s[0] for s in rec["samples"]] == sorted(
        s[0] for s in rec["samples"])


class FlipsSpy:
    """A local search that records, for every patch offered to the core's
    ``apply_region``, how many vertices of the live cover it would flip."""

    def __init__(self, ls):
        self.ls, self.flips = ls, []

    def __getattr__(self, name):
        return getattr(self.ls, name)

    def apply_region(self, k, ids, new_mask):
        now = self.ls.current()[np.asarray(ids[:k], np.int64)]
        new = (int(new_mask) >> np.arange(k)) & 1
        self.flips.append(int((now != new).sum()))
        return self.ls.apply_region(k, ids, new_mask)


def stars(*sizes):
    """Disjoint stars of ``sizes`` vertices: a centre of weight 1 and leaves
    of weight 100, every vertex in the starting cover."""
    w, edges, base = [], [], 0
    for k in sizes:
        w += [1] + [100] * (k - 1)
        edges += [[base, base + i] for i in range(1, k)]
        base += k
    w, edges = np.array(w, np.uint32), np.array(edges, np.uint32)
    return w, edges, CoreLocalSearch(w, edges, np.ones(base, np.uint8))


def test_assist_offers_no_patch_that_flips_more_than_16():
    """Two stars, of 20 and 10 vertices: the best assignment of each (its
    centre alone) flips all of its vertices.  Both are applied, the
    20-vertex star's too, which a 16-entry buffer of flipped vertices (the
    JAX package's core) could not hold; it counts as a wide patch."""
    w, edges, core_ls = stars(20, 10)
    ls = FlipsSpy(core_ls)
    cost0 = ls.cost
    assist = DeviceAssist(np.full(len(w), 0.5, np.float32), device="cpu",
                          batch=8, rmax=20, seed=1)
    assert assist.tick(ls) == 0          # dispatch only
    applied = assist.tick(ls)            # collect (CPU: already solved)
    assist.stop()
    assert sorted(ls.flips) == [10, 20]
    assert applied == assist.stats["patches"] == 2
    assert assist.stats["wide_patches"] == 1
    assert assist.stats["gain"] == cost0 - ls.cost == (19 + 9) * 100 - 2
    cur = ls.current().astype(bool)
    assert (cur[edges[:, 0]] | cur[edges[:, 1]]).all()
    assert cur[0] and cur[20] and not cur[1:20].any() and not cur[21:].any()
