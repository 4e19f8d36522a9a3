"""State carried across from numpy: the database, a batch, a config.

Both packages can then hold the same database and replay the same waves.
Word tables (uint32 in the JAX package) travel as their bit patterns:
``store_from_numpy`` reinterprets uint32 arrays as int32 tensors and
``store_to_numpy`` views them back as uint32, so comparisons are exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import (CostModel, EngineConfig, StoreState,
                                    TxnBatch)

WORD_TABLES = ("wts", "rts", "claim_w", "claim_r")
_INT_FIELDS = ("op_key", "op_group", "op_col", "op_kind", "txn_type",
               "n_ops", "op_extent")


def _words(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def store_from_numpy(arrays: dict, device) -> StoreState:
    """StoreState from {field: array}; extra fields (the JAX store's
    tables of later slices) are ignored."""
    tables = {k: _words(arrays[k], device) for k in WORD_TABLES}
    tails = torch.from_numpy(
        np.asarray(arrays["ring_tails"]).astype(np.int32)).to(device)
    return StoreState(ring_tails=tails, **tables)


def store_to_numpy(store: StoreState) -> dict:
    """{field: numpy array}, word tables as uint32."""
    out = {k: getattr(store, k).cpu().numpy().view(np.uint32)
           for k in WORD_TABLES}
    out["ring_tails"] = store.ring_tails.cpu().numpy()
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
