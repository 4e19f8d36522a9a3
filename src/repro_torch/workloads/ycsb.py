"""YCSB-like workload, per the paper's section 3.3 (port of
``repro/workloads/ycsb.py``):

  - 10M keys, each value 10 columns;
  - each transaction: 16 operations, ~50% reads / ~50% writes, each on a
    scrambled-Zipfian(theta=0.9) key and one uniformly random column;
  - fine granularity = one timestamp for even columns, one for odd
    (group = column % 2).

``ro_frac`` mixes in read-only transactions (txn_type 1).  The JAX
package's range-scan class (``scan_frac``) waits for ROADMAP A.7.
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
    theta: float = 0.9
    zipf: ZipfSampler = None  # type: ignore[assignment]

    n_groups: int = 2
    n_rings: int = 1
    n_txn_types: int = 1

    def __post_init__(self):
        n_types = 1 + (self.ro_frac > 0)
        if self.n_txn_types < n_types:
            object.__setattr__(self, "n_txn_types", n_types)

    @staticmethod
    def make(n_keys: int = 10_000_000, theta: float = 0.9,
             ops_per_txn: int = 16, write_frac: float = 0.5,
             ro_frac: float = 0.0) -> "YCSBWorkload":
        return YCSBWorkload(n_keys=n_keys, theta=theta,
                            ops_per_txn=ops_per_txn, write_frac=write_frac,
                            ro_frac=ro_frac,
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
        return 1

    def init_store(self, device=None) -> StoreState:
        return store_init(self.n_records, self.n_groups,
                          n_rings=self.n_rings, device=device)

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
        batch = TxnBatch(
            op_key=keys,
            op_group=cols % 2,  # the paper's parity split
            op_col=cols,
            op_kind=torch.where(is_w, t.WRITE, t.READ).to(torch.int32),
            op_val=torch.rand((lanes, K), generator=gen, device=dev),
            txn_type=is_ro.to(torch.int32),
            n_ops=torch.full((lanes,), K, dtype=torch.int32, device=dev),
        )
        return batch, ring_tails
