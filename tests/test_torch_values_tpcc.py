"""Tracked values on TPC-C (scale 0.01, 64 slots a transaction).

- MV-OCC coarse replaying the JAX engine's draws (tests/port_harness.py
  ``assert_values_parity``): ``values`` and ``mv_vals`` bit-identical to
  JAX ``run(..., track_values=True)``.  One case: JAX's replay unrolls
  TPC-C's 64 slots, so each case is a compile of about ten seconds.
- TPC-C's conservation law on the port: each committed payment adds 1.0
  to its warehouse's and its district's YTD, so each column sums to the
  committed payments exactly.
"""
import dataclasses

import pytest
import torch

from port_harness import assert_values_parity, jax_draws
from repro.core import types as jt
from repro.workloads import TPCCWorkload
from repro_torch.core.engine import run
from repro_torch.launch.txn_bench import make_config, make_workload
from repro_torch.workloads import tpcc as ptpcc

SEED = 3


@pytest.mark.parametrize("cc,gran", [(jt.CC_MVOCC, 0)],
                         ids=["mvocc-coarse"])
def test_tpcc_values_match_jax(cc, gran):
    wl = TPCCWorkload.make(scale=0.01)
    state = assert_values_parity(wl, cc, gran, 16,
                                 jax_draws(wl, 16, 3, seed=SEED), seed=SEED)
    assert int(state.commits) > 0


@pytest.mark.parametrize("cc", ["occ", "tictoc", "mvcc"])
def test_tpcc_conservation(cc):
    wl = make_workload("tpcc", scale=0.01)
    cfg = dataclasses.replace(make_config(wl, cc, 1, 32),
                              track_values=True)
    res = run(cfg, wl, 8, seed=1, device="cpu", keep_state=True)
    vals = res.final_state.store.values
    payments = res.commits_by_type[ptpcc.PAYMENT]
    assert payments > 0
    w_rows = torch.arange(wl.n_warehouses)
    d_rows = wl.d_base + torch.arange(wl.n_dist_total)
    assert float(vals[w_rows, ptpcc.W_YTD].sum()) == payments
    assert float(vals[d_rows, ptpcc.D_YTD].sum()) == payments
