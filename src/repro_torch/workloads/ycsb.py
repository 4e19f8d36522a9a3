"""YCSB-like workload, per the paper's section 3.3 (port of
``repro/workloads/ycsb.py``):

  - 10M keys, each value 10 columns;
  - each transaction: 16 operations, ~50% reads / ~50% writes, each on a
    scrambled-Zipfian(theta=0.9) key and one uniformly random column;
  - fine granularity = one timestamp for even columns, one for odd
    (group = column % 2).

``ro_frac`` mixes in read-only transactions (txn_type 1).  ``scan_frac``
mixes in short-range scan transactions (YCSB workload E), their own
txn_type after the read-only class: op 0 is one interval READ of
``scan_len`` consecutive keys (a Zipfian start, clamped to stay in the
table), op 1 a point WRITE, the other slots masked.  Scan lanes are update
transactions, so every serializable mechanism must phantom-protect the
interval.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import types as t
from repro_torch.core.types import StoreState, TxnBatch, store_init
from repro_torch.workloads.zipf import ZipfSampler


@dataclasses.dataclass(frozen=True)
class YCSBWorkload:
    n_keys: int = 10_000_000
    n_cols_schema: int = 10
    ops_per_txn: int = 16
    write_frac: float = 0.5
    ro_frac: float = 0.0
    scan_frac: float = 0.0
    scan_len: int = 8
    theta: float = 0.9
    zipf: ZipfSampler = None  # type: ignore[assignment]

    n_groups: int = 2
    n_rings: int = 1
    n_txn_types: int = 1

    def __post_init__(self):
        n_types = 1 + (self.ro_frac > 0) + (self.scan_frac > 0)
        if self.n_txn_types < n_types:
            object.__setattr__(self, "n_txn_types", n_types)
        if self.scan_frac > 0 and not 1 <= self.scan_len <= self.n_keys:
            raise ValueError(
                f"scan_len must be in [1, n_keys], got {self.scan_len}")

    @staticmethod
    def make(n_keys: int = 10_000_000, theta: float = 0.9,
             ops_per_txn: int = 16, write_frac: float = 0.5,
             ro_frac: float = 0.0, scan_frac: float = 0.0,
             scan_len: int = 8) -> "YCSBWorkload":
        return YCSBWorkload(n_keys=n_keys, theta=theta,
                            ops_per_txn=ops_per_txn, write_frac=write_frac,
                            ro_frac=ro_frac, scan_frac=scan_frac,
                            scan_len=scan_len,
                            zipf=ZipfSampler.make(n_keys, theta))

    @property
    def n_records(self) -> int:
        return self.n_keys

    @property
    def n_cols(self) -> int:
        return self.n_cols_schema

    @property
    def slots(self) -> int:
        return self.ops_per_txn

    @property
    def max_extent(self) -> int:
        """Widest interval an op carries: scan_len with the scan class."""
        return self.scan_len if self.scan_frac > 0 else 1

    def init_store(self, device=None, mv_depth: int = 0,
                   track_values: bool = False) -> StoreState:
        """A fresh store; ``track_values`` gives it the record values
        (``n_cols`` columns, zeros)."""
        return store_init(self.n_records, self.n_groups,
                          n_rings=self.n_rings, device=device,
                          mv_depth=mv_depth,
                          n_cols=self.n_cols if track_values else 0)

    def gen(self, gen: torch.Generator, wave: int, lanes: int,
            ring_tails: torch.Tensor):
        dev = ring_tails.device
        K = self.ops_per_txn
        if self.ro_frac > 0:
            is_ro = torch.rand((lanes,), generator=gen,
                               device=dev) < self.ro_frac
        else:
            is_ro = torch.zeros((lanes,), dtype=torch.bool, device=dev)
        keys = self.zipf.sample(gen, (lanes, K), dev)
        cols = torch.randint(0, self.n_cols_schema, (lanes, K),
                             generator=gen, device=dev, dtype=torch.int32)
        is_w = torch.rand((lanes, K), generator=gen,
                          device=dev) < self.write_frac
        is_w = is_w & ~is_ro[:, None]
        op_key = keys
        op_kind = torch.where(is_w, t.WRITE, t.READ).to(torch.int32)
        op_extent = torch.ones((lanes, K), dtype=torch.int32, device=dev)
        n_ops = torch.full((lanes,), K, dtype=torch.int32, device=dev)
        txn_type = is_ro.to(torch.int32)
        if self.scan_frac > 0:
            is_sc = (torch.rand((lanes,), generator=gen, device=dev)
                     < self.scan_frac) & ~is_ro
            # Op 0: the interval READ (clamped in the table); op 1: a
            # point WRITE; the rest masked.
            col = torch.arange(K, device=dev)[None, :]
            sc = is_sc[:, None]
            start = torch.clamp(keys[:, :1], max=self.n_keys - self.scan_len)
            op_key = torch.where(
                sc, torch.where(col == 0, start,
                                torch.where(col == 1, keys[:, 1:2], -1)),
                op_key).to(torch.int32)
            op_kind = torch.where(
                sc & (col == 1), t.WRITE,
                torch.where(sc, t.READ, op_kind)).to(torch.int32)
            op_extent = torch.where(sc & (col == 0), self.scan_len,
                                    op_extent).to(torch.int32)
            n_ops = torch.where(is_sc, 2, n_ops).to(torch.int32)
            txn_type = torch.where(is_sc, 1 + int(self.ro_frac > 0),
                                   txn_type).to(torch.int32)
        batch = TxnBatch(
            op_key=op_key,
            op_group=cols % 2,  # the paper's parity split
            op_col=cols,
            op_kind=op_kind,
            op_val=torch.rand((lanes, K), generator=gen, device=dev),
            txn_type=txn_type,
            n_ops=n_ops,
            op_extent=op_extent,
        )
        return batch, ring_tails
