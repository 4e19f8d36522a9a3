"""State carried across from numpy: the database, a batch, a config.

Both packages can then hold the same database and replay the same waves.
Word tables (uint32 in the JAX package: the timestamp and claim tables and
the version ring's begin stamps) travel as their bit patterns:
``store_from_numpy`` reinterprets uint32 arrays as int32 tensors and
``store_to_numpy`` views them back as uint32, so comparisons are exact.
The engine state's conflict histogram (``conflict_hits``,
``conflict_peak``, uint32 words too) travels the same way
(``conflicts_from_numpy``, ``conflicts_to_numpy``).
The per-record tables (mode bits, heats, heat waves, ring heads) travel
with their own dtypes; the mode and heat tables gain their zero sink slot
(``core/types.SINK``) on the way in and lose it on the way out.  The
sharded engine's tables (core/distributed.py) travel as global arrays:
``dist_tables_from_numpy`` gives each rank its ``rec_per`` rows,
``dist_tables_to_numpy`` gathers them back.  A language
model's parameters and decode cache travel from the JAX package's stacked
stages to the port's per-layer lists (``lm_params_from_jax``,
``lm_cache_from_jax``); bfloat16 arrays keep their bit patterns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import DistConfig, n_shards
from repro_torch.core.mvstore import mv_placeholder
from repro_torch.core.types import (SINK, SINK_TABLES, CostModel,
                                    EngineConfig, EngineState, StoreState,
                                    TxnBatch)
from repro_torch.models.common import tree_map

WORD_TABLES = ("wts", "rts", "claim_w", "claim_r", "mv_begin")
CONFLICT_TABLES = ("conflict_hits", "conflict_peak")
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
        a = np.asarray(arrays[k]).astype(dtype)
        if k in SINK_TABLES:
            a = np.concatenate([a, np.zeros(SINK, dtype)])
        tables[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tables["mv_vals"] = mv_placeholder(device)[2]
    return StoreState(**tables)


def store_to_numpy(store: StoreState) -> dict:
    """{field: numpy array}, word tables as uint32."""
    out = {k: getattr(store, k).cpu().numpy().view(np.uint32)
           for k in WORD_TABLES}
    for k in RECORD_TABLES:
        a = getattr(store, k).cpu().numpy()
        out[k] = a[:-SINK] if k in SINK_TABLES else a
    return out


def conflicts_from_numpy(arrays: dict, device) -> dict:
    """{field: int32 tensor} of the conflict tables in ``arrays`` (the
    JAX state's uint32 ``conflict_hits`` and ``conflict_peak``), for
    ``dataclasses.replace`` of an EngineState."""
    return {k: _words(arrays[k], device) for k in CONFLICT_TABLES}


def conflicts_to_numpy(state: EngineState) -> dict:
    """{field: uint32 array} of the state's conflict tables."""
    return {k: getattr(state, k).cpu().numpy().view(np.uint32)
            for k in CONFLICT_TABLES}


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


def dist_config_from_fields(fields: dict) -> DistConfig:
    """DistConfig from the JAX DistConfig's fields (``dataclasses.asdict``):
    its TPU-only ``backend`` and ``lane_block`` are dropped."""
    return DistConfig(**{k: v for k, v in fields.items()
                         if k not in ("backend", "lane_block")})


def _dist_words(cfg: DistConfig) -> tuple:
    """Which of the mechanism's tables hold uint32 words: all but the MV
    ring's heads."""
    return (True, True, True, False) if cfg.is_mv else (True, True)


def dist_tables_from_numpy(cfg: DistConfig, arrays, rank: int, ns: int,
                           device) -> tuple:
    """Rank ``rank``'s slice (rows ``[rank * rec_per, (rank + 1) *
    rec_per)``) of the global tables ``arrays`` (the JAX ``init_tables``
    layout, padded to ``ns * rec_per`` records), on ``device``."""
    rec_per = -(-cfg.n_records // ns)
    out = []
    for a, word in zip(arrays, _dist_words(cfg)):
        a = np.asarray(a)[rank * rec_per:(rank + 1) * rec_per]
        out.append(_words(a, device) if word else torch.from_numpy(
            np.ascontiguousarray(a.astype(np.int32))).to(device))
    return tuple(out)


def dist_tables_to_numpy(cfg: DistConfig, tables, group=None) -> tuple:
    """The global tables, gathered from every rank of ``group`` (word
    tables as uint32)."""
    ns = n_shards(group)
    out = []
    for x, word in zip(tables, _dist_words(cfg)):
        parts = [torch.empty_like(x) for _ in range(ns)]
        dist.all_gather(parts, x.contiguous(), group=group)
        a = torch.cat(parts).cpu().numpy()
        out.append(a.view(np.uint32) if word else a)
    return tuple(out)


# ------------------------------------------------------------ language models
def tensor_from_numpy(a, device) -> torch.Tensor:
    """A tensor holding numpy array ``a``; ml_dtypes' bfloat16 arrays (the
    JAX package's) travel as their 16-bit patterns."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _unstack(cfg, stages: list, device) -> list:
    """Per-layer trees from the JAX stacked stages: stage ``si``, key
    ``str(i)``, repeat ``j`` is decoder layer ``offset_si + j *
    len(pattern) + i``."""
    layers = [None] * cfg.n_layers
    offset = 0
    for si, (pattern, n) in enumerate(cfg.stage_split()):
        for i in range(len(pattern)):
            for j in range(n):
                layers[offset + j * len(pattern) + i] = tree_map(
                    lambda a: tensor_from_numpy(np.asarray(a)[j], device),
                    stages[si][str(i)])
        offset += n * len(pattern)
    assert all(x is not None for x in layers)
    return layers


def lm_params_from_jax(cfg, tree, device="cpu") -> dict:
    """The port's parameters (``models/model.py``) from the JAX
    ``init_params`` tree, as numpy arrays."""
    out = {k: tree_map(lambda a: tensor_from_numpy(a, device), tree[k])
           for k in ("embed", "final_norm", "head") if k in tree}
    out["layers"] = _unstack(cfg, tree["stages"], device)
    return out


def lm_cache_from_jax(cfg, stages: list, device="cpu") -> list:
    """The port's per-layer decode cache from the JAX cache (one stacked
    tree per stage), as numpy arrays."""
    return _unstack(cfg, stages, device)
