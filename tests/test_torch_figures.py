"""The port's figure scripts (src/repro_torch/benchmarks/) and its
quickstart (examples/quickstart_torch.py) at a tiny size on the CPU.

Each entry point's ``main`` runs with ``--device cpu``, a few waves and a
small table (TPC-C scale 0.01, YCSB 2,000 keys; their grids as the JAX
twins'), and must print its ordering and ratio lines beside the paper's
numbers and return rows that carry every key of the JAX CLI's rows
(``repro.launch.txn_bench.run_grid`` on a tiny grid, closed and open
loop), the cost-model columns included.  The
orderings themselves are the card's to show at the figures' own sizes:
at this size a few waves decide them.  scan_mix runs at its twin's 64
lanes on the 2,000-key table, where its phantom checks (coarse at least
fine's phantoms; none under MVCC) have the contention to hold.
"""
import json
import os
import sys

import pytest

from repro.launch.txn_bench import run_grid as jax_run_grid
from repro_torch.analysis.trace import validate_chrome_trace
from repro_torch.benchmarks import (abort_rates, auto_granularity, common,
                                    fig2_ycsb, fig3_tpcc, open_loop,
                                    scan_mix)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))
import quickstart_torch  # noqa: E402

@pytest.fixture(scope="module")
def jax_keys():
    """(closed-loop row keys, open-loop row keys) of the JAX CLI, the
    cost-model columns (analysis/txn_cost.py) included."""
    kw = dict(n_keys=2000, seed=0)
    closed = jax_run_grid("ycsb", ["occ"], (0,), [8], 2, **kw)[0]
    opened = jax_run_grid("ycsb", ["occ"], (0,), [8], 2, arrival_rate=4.0,
                          **kw)[0]
    return set(closed), set(opened)


def _json(tmp_path):
    return ["--device", "cpu", "--json", str(tmp_path / "rows.json")]


#: The JAX rows' probe-chain columns, which only the probe family carries
#: (the port's rows carry ``launches_per_wave`` for every mechanism).
CHAIN_KEYS = {"launches_per_wave", "dma_rows_per_wave",
              "dma_rows_per_wave_unfused"}
PROBE_FAMILY = {"occ", "tictoc", "2pl", "swisstm", "adaptive"}


def _check_rows(rows, keys):
    assert rows
    for r in rows:
        need = keys if r["cc"] in PROBE_FAMILY else keys - CHAIN_KEYS
        missing = need - set(r)
        assert not missing, (r["cc"], missing)
        assert r["backend"] == "cpu" and r["device_name"] == "cpu"
        assert r["commits"] + r["aborts"] == r["lanes"] * r["waves"] or \
            r.get("open_loop")
        assert sum(r["abort_causes"].values()) == r["aborts"]


def test_fig3_tpcc(jax_keys, tmp_path, capsys):
    rows = fig3_tpcc.main(["--waves", "2"] + _json(tmp_path), scale=0.01)
    _check_rows(rows, jax_keys[0])
    assert len(rows) == len(common.CCS) * 2 * len(common.LANES)
    assert {r["lanes_run"] for r in rows if r["lanes"] == 96} == {128}
    out = capsys.readouterr().out
    assert "OCC-fine@96 / TicToc-coarse@96" in out and "(paper: 1.37x)" in out
    assert "OCC-fine@128 / TicToc-fine@128" in out and "(paper: 1.14x)" in out
    assert out.count("(paper: >1)") == 2
    assert (tmp_path / "rows.json").exists()


def test_fig2_ycsb(jax_keys, tmp_path, capsys):
    rows = fig2_ycsb.main(["--waves", "2"] + _json(tmp_path), n_keys=2000)
    _check_rows(rows, jax_keys[0])
    out = capsys.readouterr().out
    assert "2a: TicToc/OCC at T=8" in out
    assert out.count("(paper: <1)") == 3 and out.count("(paper: >1)") == 7


def test_abort_rates(jax_keys, tmp_path, capsys):
    rows = abort_rates.main(["--waves", "2"] + _json(tmp_path), scale=0.01,
                            n_keys=2000)
    _check_rows(rows, jax_keys[0])
    out = capsys.readouterr().out
    assert "(paper: 9.79% vs 17.57%)" in out
    assert "(paper: 30.91% -> 1.75%)" in out
    assert "snapshot readers never abort" in out
    for r in rows:
        if r["cc"] in ("mvcc", "mvocc"):
            assert r["ro_aborts"] == 0


def test_auto_granularity(jax_keys, tmp_path, capsys):
    rows = auto_granularity.main(["--waves", "2", "--lanes", "8", "16"]
                                 + _json(tmp_path), scale=0.01)
    _check_rows(rows, jax_keys[0])
    out = capsys.readouterr().out
    assert out.count("of the fine-granularity gain") == 2


def test_open_loop(jax_keys, tmp_path, capsys):
    rows = open_loop.main(["--waves", "3", "--lanes", "8", "--n-keys",
                           "2000"] + _json(tmp_path))
    _check_rows(rows, jax_keys[1])
    for r in rows:
        assert r["admitted"] == (r["commits"] + r["queued_final"]
                                 + r["inc_drops"])
        assert r["offered"] == r["admitted"] + r["arrival_drops"]
        assert r["reenq_drops"] == 0
    out = capsys.readouterr().out
    assert out.count("fine/coarse goodput") == 2
    trace = tmp_path / "trace.json"
    open_loop.main(["--waves", "2", "--lanes", "8", "--n-keys", "2000",
                    "--rates", "4", "--trace", str(trace)] + _json(tmp_path))
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) == []
    labels = [e["args"]["name"] for e in doc["traceEvents"]
              if e["name"] == "process_name"]
    assert labels == ["occ/coarse/rate4", "mvcc/coarse/rate4",
                      "occ/fine/rate4", "mvcc/fine/rate4"]


def test_scan_mix(jax_keys, tmp_path, capsys):
    rows = scan_mix.main(["--waves", "3", "--n-keys", "2000"]
                         + _json(tmp_path))
    _check_rows(rows, jax_keys[1])
    assert {r["max_extent"] for r in rows} == {4, 16, 64}
    out = capsys.readouterr().out
    assert out.count("phantoms coarse=") == 6 * len(scan_mix.CCS)


def test_quickstart(capsys):
    res = quickstart_torch.main(["--device", "cpu"], scale=0.01, lanes=16,
                                waves=4)
    assert set(res) == {"occ-coarse", "occ-fine", "tictoc-coarse"}
    for r in res.values():
        assert r.commits + r.aborts == 16 * 4 and r.device == "cpu"
    out = capsys.readouterr().out
    assert "(the paper's headline: 1.37x at 96 threads)" in out
