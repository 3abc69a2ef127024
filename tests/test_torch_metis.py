"""The port's METIS reader (one native pass, ``core/src/metisio.hpp``)
against the JAX package's ``read_metis``: the same arrays, dtypes included,
on generated files and on small texts that exercise every rule of the
dialect, and a refusal wherever the JAX reader refuses; its ``rows_sorted``
counter, and the counter in ``gnn-vc-torch --json``."""

import contextlib
import io
import json
import os
import tempfile

import numpy as np
import pytest

from gnn_mwvc_tpu.graphio import read_metis as jax_read_metis
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.graphio import read_metis, write_metis
from perfbench.yardstick import geometric
from perfbench.yardstick.graphs import road_csr

SEPS = (" ", "\t", "  ", " \t", "\t ")


def _csr_file(csr):
    """The METIS text the benchmark's writer makes of a sorted CSR."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.metis")
        geometric.write_metis(path, *csr)
        with open(path, "rb") as f:
            return f.read()


def _random_text(seed):
    """A small METIS text with what a hand-written file may hold: unsorted
    rows, duplicate, one-sided and out-of-order entries, self-loops,
    signed tokens, tabs and runs of separators, ``\\r\\n`` line ends, blank
    trailing lines, lines after the n-th and a missing final newline."""
    rng = np.random.default_rng(seed)

    def sep():
        return SEPS[int(rng.integers(len(SEPS)))]

    n = int(rng.integers(1, 40))
    end = "\r\n" if rng.random() < 0.5 else "\n"
    lines = []
    for u in range(n):
        toks = [str(int(rng.integers(-5, 1000)))]
        deg = int(rng.integers(0, 8))
        nbrs = rng.integers(1, n + 1, size=deg).tolist()
        if rng.random() < 0.3:
            nbrs.append(u + 1)  # a self-loop
        if rng.random() < 0.3 and nbrs:
            nbrs.append(nbrs[0])  # a duplicate
        if rng.random() < 0.5:
            nbrs.sort()
        for t in nbrs:
            r = rng.random()
            toks.append(f"+{t}" if r < 0.1 else
                        str(-t) if r < 0.15 else str(t))
        lead = sep() if rng.random() < 0.2 else ""
        trail = sep() if rng.random() < 0.3 else ""
        lines.append(lead + "".join(
            t + (sep() if i < len(toks) - 1 else "")
            for i, t in enumerate(toks)) + trail)
    for _ in range(int(rng.integers(0, 3))):  # lines after the n-th
        extra = rng.integers(-9, 99, size=int(rng.integers(0, 4)))
        lines.append(" ".join(str(int(x)) for x in extra))
    text = f"{n} {int(rng.integers(0, 99))} 10{end}" + end.join(lines)
    if rng.random() < 0.7:
        text += end * int(rng.integers(1, 3))
    return text.encode()


ACCEPTED = {
    "ex3": b"3 2 10\n15 3\n15 3\n20 1 2\n",
    "dedup_and_selfloop": b"3 3 10\n5 2 2\n6 1 3\n7 2 3\n",
    "unsorted_rows": b"4 4 10\n1 4 2 3\n2 1 4\n3 1\n4 2 1\n",
    "two_unsorted_rows": b"4 4 10\n1 4 2\n2 1\n3 4 1 2 4\n4 1 3\n",
    "one_sided": b"4 2 10\n1 3\n2\n3\n4 2\n",
    "tabs_crlf_signed": b"3 2 10\r\n\t+15\t3\r\n15  -3 +3\r\n20 1\t2\t\r\n",
    "blank_trailing_lines": b"2 1 10\n5 2\n6 1\n\n\n  \n",
    "lines_after_n": b"2 1 10\n5 2\n6 1\n7 1 2\n8\n",
    "no_final_newline": b"3 2 10\n1 2\n2 1 3\n3 2",
    "isolated_and_negative_weight": b"3 0 10\n-4\n0\n7\n",
}
REFUSED = {
    "non_integer": b"2 1 10\n5 2\n5 1.5\n",
    "non_integer_after_n": b"2 1 10\n5 2\n5 1\nabc\n",
    "sign_alone": b"2 1 10\n5 - 2\n5 1\n",
    "no_weight": b"3 2 10\n1 2\n\n3 2\n",
    "fewer_lines_than_n": b"4 2 10\n1 2\n2 1\n",
    "empty_body": b"2 0 10\n",
    "neighbour_beyond_n": b"2 1 10\n5 3\n5 1\n",
}
TEXTS = {**ACCEPTED, **REFUSED}
CASES = (["rgg12", "road64"] + [f"text:{k}" for k in TEXTS]
         + [f"random:{s}" for s in range(24)])


def _case(name):
    if name == "rgg12":
        return _csr_file(geometric.rgg_csr(12, 7))
    if name.startswith("road"):
        return _csr_file(road_csr(int(name[4:]), 2**31 + 11))
    kind, key = name.split(":")
    return TEXTS[key] if kind == "text" else _random_text(int(key))


@pytest.mark.parametrize("name", CASES)
def test_reader_equals_the_jax_reader(name):
    data = _case(name)
    try:
        theirs = jax_read_metis(io.BytesIO(data))
    except Exception:
        with pytest.raises(ValueError):
            read_metis(io.BytesIO(data))
        return
    mine = read_metis(io.BytesIO(data))
    assert (mine.n, mine.m) == (theirs.n, theirs.m)
    for field in ("weights", "indptr", "indices"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype == np.int64, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_every_refused_text_is_refused_by_the_jax_reader():
    """The refusals the differential test checks are the JAX reader's
    too: each of these texts raises there."""
    for text in REFUSED.values():
        with pytest.raises(Exception):
            jax_read_metis(io.BytesIO(text))


@pytest.mark.parametrize("key,line", [
    ("non_integer", 2), ("non_integer_after_n", 3), ("sign_alone", 1),
    ("no_weight", 2), ("fewer_lines_than_n", 3), ("empty_body", 1),
    ("neighbour_beyond_n", 1)])
def test_refusal_names_the_line(key, line):
    with pytest.raises(ValueError, match=rf"line {line}\b"):
        read_metis(io.BytesIO(REFUSED[key]))


@pytest.mark.parametrize("name,count", [
    ("text:dedup_and_selfloop", 1),  # line 1 lists 2 twice
    ("text:two_unsorted_rows", 2),  # lines 1 (4 before 2) and 3 (4 twice)
    ("text:unsorted_rows", 1),  # line 1; line 4 keeps no entry
    ("road32", 0), ("rgg12", 0),
])
def test_rows_sorted_counts_the_rows_that_took_the_sort(name, count):
    stats = {}
    read_metis(io.BytesIO(_case(name)), stats)
    assert stats == {"rows_sorted": count}


def test_path_text_and_binary_files_read_alike(tmp_path):
    g = build_road_graph(12)
    path = tmp_path / "g.metis"
    write_metis(str(path), g)
    with open(path) as text, open(path, "rb") as binary:
        for src in (str(path), text, binary):
            h = read_metis(src)
            for field in ("weights", "indptr", "indices"):
                np.testing.assert_array_equal(getattr(h, field),
                                              getattr(g, field))


def test_cli_json_carries_read_rows_sorted(tmp_path):
    from gnn_mwvc_tpu_torch.solver import cli

    path = tmp_path / "g.metis"
    write_metis(str(path), build_road_graph(10))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(path), str(tmp_path / "g.sol"), "0", "-1", "0",
                       "--json", "--device", "cpu"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["read_rows_sorted"] == 0
    assert set(line["cli_spans"]) == {"read", "output"}
