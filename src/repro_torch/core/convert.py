"""State carried across from numpy: the database, a batch, a config.

Both packages can then hold the same database and replay the same waves.
Word tables (uint32 in the JAX package: the timestamp and claim tables and
the version ring's begin stamps) travel as their bit patterns:
``store_from_numpy`` reinterprets uint32 arrays as int32 tensors and
``store_to_numpy`` views them back as uint32, so comparisons are exact.
The per-record tables (mode bits, heats, heat waves, ring heads) travel
with their own dtypes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.mvstore import mv_placeholder
from repro_torch.core.types import (CostModel, EngineConfig, StoreState,
                                    TxnBatch)

WORD_TABLES = ("wts", "rts", "claim_w", "claim_r", "mv_begin")
RECORD_TABLES = {"ring_tails": np.int32, "pess_mode": np.bool_,
                 "abort_heat": np.float32, "fine_mode": np.bool_,
                 "false_heat": np.float32, "heat_wave": np.int32,
                 "mv_head": np.int32}
_INT_FIELDS = ("op_key", "op_group", "op_col", "op_kind", "txn_type",
               "n_ops", "op_extent")


def _words(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def store_from_numpy(arrays: dict, device) -> StoreState:
    """StoreState from {field: array}; the JAX store's tracked values
    (``values``, ``mv_vals``) are ignored (ROADMAP A.4)."""
    tables = {k: _words(arrays[k], device) for k in WORD_TABLES}
    for k, dtype in RECORD_TABLES.items():
        tables[k] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(arrays[k]).astype(dtype))).to(device)
    tables["mv_vals"] = mv_placeholder(device)[2]
    return StoreState(**tables)


def store_to_numpy(store: StoreState) -> dict:
    """{field: numpy array}, word tables as uint32."""
    out = {k: getattr(store, k).cpu().numpy().view(np.uint32)
           for k in WORD_TABLES}
    out.update({k: getattr(store, k).cpu().numpy() for k in RECORD_TABLES})
    return out


def batch_from_numpy(arrays: dict, device) -> TxnBatch:
    """TxnBatch from {field: array} (op_extent optional)."""
    fields = {}
    for f in dataclasses.fields(TxnBatch):
        a = arrays.get(f.name)
        if a is None:
            continue
        dtype = np.int32 if f.name in _INT_FIELDS else np.float32
        fields[f.name] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(a).astype(dtype))).to(device)
    return TxnBatch(**fields)


def config_from_fields(fields: dict) -> EngineConfig:
    """EngineConfig from the JAX config's fields (``dataclasses.asdict``):
    its TPU-only ``backend`` and ``lane_block`` are dropped."""
    f = {k: v for k, v in fields.items() if k not in ("backend", "lane_block")}
    if isinstance(f.get("cost"), dict):
        f["cost"] = CostModel(**f["cost"])
    return EngineConfig(**f)
