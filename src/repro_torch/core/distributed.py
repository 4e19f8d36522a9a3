"""The sharded wave engine on ``torch.distributed`` (port of
``repro/core/distributed.py``, the synchronous wave).

The record space is range-sharded over the ranks of one process group:
rank r owns records ``[r * rec_per, (r + 1) * rec_per)`` of the claim,
version and ring tables, and runs ``lanes_per_shard`` lanes of its own.
One wave is four shard-local phases joined by three exchanges:

  1. route    every op goes to its key's owner.  ``route_pack`` builds
              fixed-capacity per-destination buffers in the stable order
              of the flat ops (ops past a destination's capacity drop and
              abort their lane); the key and meta channels are exchanged.
              An interval (scan) op splits at its range-shard boundary
              into at most two fragments.
  2. claim    owners install the routed write claims and probe them:
              OCC through the fused ``wave_commit`` (or ``claim_probe``
              when ``fuse_wave`` is off), MVCC/MV-OCC through one
              ``claim_probe`` call on both claim channels that also
              reads the version ring (``mv_gather``'s select); scan
              fragments through ``iterate_validate``.
              The per-op verdicts go back 2 bits an op, 16 ops a word
              (the wire format of ``verdict_pack``): the claim call
              writes the words itself (``wave_commit(..., pack=True)``,
              ``claim_probe``'s verdict form) and ``iterate_validate``
              ORs the scan verdicts into them (``words=``).
  3. commit   senders unpack the verdicts at each op's routing
              coordinates (``verdict_unpack``'s gather form, one launch),
              decide their lanes and classify the abort causes; the
              commit bits go back packed the same way, each buffer cell
              packing its lane's bit (``verdict_pack``'s gather form
              through route_pack's lane channel, one launch).
  4. install  owners bump versions of committed writes
              (``commit_install``) or publish ring slots (``mv_install``),
              each reading the arrived commit words itself (``words=``).

So each wave launches ``verdict_pack`` and ``verdict_unpack`` once each,
on the sender's side; the owner's side has no pack or unpack launch.

The API is per rank.  ``make_wave_fn(cfg, group)`` gives ``wave(keys [T,
K], groups, kinds, prio [T], tables, wave) -> (commit bool[T], tables,
stats int32[STATS_LEN])`` on this rank's lanes and table slices
(``init_tables``), which it updates in place.  ``prio`` is this rank's
slice of one permutation of all ranks' lanes, so prio16 is unique across
shards; with scans ``kinds`` packs ``kind | extent << 2``.  The exchange is
one ``all_to_all_single`` over the group: row i of the buffer goes to
rank i, and row i of what arrives came from rank i.  The tensors' device
picks the kernels: CUDA tensors (an NCCL group) launch the CUDA kernels,
CPU tensors (a gloo group) run their plain versions.  The wave index is a
0-d int64 tensor on that device (an int is copied there), which the
kernels read from device memory and ``make_run_fn`` advances there.

The open loop (``queue_cap >= 1``) puts a fixed-capacity admission ring
on each rank in front of the same shard body (``init_open_queue``,
``make_open_wave_fn``, ``run_open_loop``): arrivals enqueue, up to T
lanes leave FIFO, the routed wave runs, aborted lanes re-enqueue with
incarnation + 1 or drop at the cap, committed lanes record their
time-to-commit, all with core/admission.py's ``ring_enqueue`` and
``record_ttc``, on the device.

Software pipeline (``pipeline_depth >= 2`` on more than one shard, or
forced on one by ``_pipelined_run`` / ``_open_pipelined_run``): route
never reads the tables, so wave w's routing runs while the owners claim
wave w-1, and the verdict and commit words ride with wave w's outbound
buffers in ONE exchange a step.  Step s (wave w = wave0 + s):

    1. owner-install  wave w-3  (commit words arrived last step)
    2. owner-claim    wave w-1  (routed buffers arrived last step) -> V
    3. sender-commit  wave w-2  (verdict words arrived last step)  -> C
    4. route          wave w                                       -> O
    5. one exchange of [O_key | O_meta | V | C]

Three owner-side routed-buffer slots and two sender-side coordinate slots
carry the waves in flight; the warm-up steps run on NO_OP-filled buffers
(every op masked: no table write) and three NOP waves drain the pipe.
The result equals the synchronous wave's bit for bit (OCC always, MVCC
and MV-OCC at ``snapshot_age`` 0, which DistConfig enforces at depth >=
2).  The open loop's retries re-enqueue two waves after they ran, and a
retry the full ring rejects leaves as an incarnation drop.

The axis-wise exchange (``topology="axiswise"`` on a mesh of two or more
axes) runs one ``all_to_all_single`` per mesh axis, each over that axis's
subgroup (``mesh_groups``), at the axes' count times the flat bytes.
Values are not tracked on the sharded path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import admission
from repro_torch.core import backend as kb
from repro_torch.core import mvstore
from repro_torch.core import types as t
from repro_torch.core.claimword import device_scalar
from repro_torch.core.ranges import in_range
from repro_torch.core.types import resolve_device

NO_OP = 0x7FFFFFFF       # empty buffer cell in the key channel
META_FILL = 0x7FFF8      # empty meta: group 0, kind NOP, prio16 NO_PRIO
LANE_FILL = -1           # empty cell in the local slot -> lane map

#: Mechanisms the routed wave implements.
DIST_CCS = ("occ", "mvcc", "mvocc")
DIST_MV_CCS = ("mvcc", "mvocc")

#: Exchange factorings (DistConfig.topology).
TOPOLOGIES = ("flat", "axiswise")

#: Stats vector layout per shard (int32[STATS_LEN]): commits, aborts,
#: capacity-dropped lanes, dropped ops, read-only commits and aborts, four
#: open-loop slots (zero in the closed wave), then the N_ABORT_CAUSES
#: per-cause abort counts, which sum to the aborts slot.
STATS_LEN = 10 + t.N_ABORT_CAUSES
STAT_COMMITS, STAT_ABORTS, STAT_DROPPED_LANES, STAT_DROPPED_OPS, \
    STAT_RO_COMMITS, STAT_RO_ABORTS, STAT_ADMITTED, STAT_ARRIVAL_DROPS, \
    STAT_INC_DROPS, STAT_QUEUED = range(10)
STAT_CAUSE0 = 10
STAT_CAUSES = slice(STAT_CAUSE0, STAT_CAUSE0 + t.N_ABORT_CAUSES)

def verdict_words(cap: int) -> int:
    """int32 wire words per ``cap``-op verdict row: 2 bits per op, 16 ops
    per word (kernels/verdict_pack.py)."""
    return -(-cap // 16)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """The JAX package's DistConfig, less its TPU-only ``backend`` and
    ``lane_block`` knobs (the tensors' device picks the kernels)."""
    n_records: int
    n_groups: int = 2
    lanes_per_shard: int = 64      # T_loc
    slots: int = 16                # K ops per txn
    route_cap: int = 0             # 0 = auto: 4x fair share, 8-aligned
    granularity: int = 1           # 0 coarse / 1 fine (probe width)
    cc: str = "occ"                # "occ", "mvcc" or "mvocc"
    mv_depth: int = 0              # version-ring depth (mvcc/mvocc only)
    snapshot_age: int = 0          # MV snapshots pinned this many waves back
    pipeline_depth: int = 1        # 1 = the synchronous wave
    topology: str = "flat"         # "flat": one all_to_all over the group
    queue_cap: int = 0             # open-loop admission ring (0 = closed)
    max_incarnations: int = 0
    lat_bins: int = 32
    max_extent: int = 1            # widest op interval; > 1 enables scans
    bucket_size: int = 8           # coarse interval-claim bucket width
    fuse_wave: bool = True         # OCC's owner claim as one wave_commit

    def __post_init__(self):
        if self.cc not in DIST_CCS:
            raise ValueError(f"unknown distributed cc {self.cc!r} "
                             f"(expected one of {DIST_CCS})")
        if self.cc in DIST_MV_CCS and self.mv_depth < 1:
            raise ValueError(
                f"cc={self.cc!r} needs the multi-version ring: set "
                "DistConfig.mv_depth >= 1 (the local benchmarks use 4)")
        if self.cc not in DIST_MV_CCS and self.mv_depth:
            raise ValueError(
                f"mv_depth={self.mv_depth} is set but cc={self.cc!r} has "
                "no version ring — use cc='mvcc' or 'mvocc'")
        if self.snapshot_age < 0:
            raise ValueError(
                f"snapshot_age must be >= 0, got {self.snapshot_age}")
        if self.snapshot_age > 0 and self.cc not in DIST_MV_CCS:
            raise ValueError(
                f"snapshot_age={self.snapshot_age} needs a multi-version "
                f"cc (mvcc/mvocc): {self.cc!r} has no snapshots to age")
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth={self.pipeline_depth} must be >= 1 "
                "(1 = the synchronous wave; >= 2 = the software pipeline "
                "of the scanned runners)")
        if self.pipeline_depth > 1 and self.snapshot_age > 0:
            raise ValueError(
                f"pipeline_depth={self.pipeline_depth} with snapshot_age="
                f"{self.snapshot_age}: the pipelined wave's ring read runs "
                "one wave before the previous wave's mv_install lands, so "
                "an aged snapshot could read a ring slot the synchronous "
                "engine had already reclaimed; aged readers must run at "
                "pipeline_depth=1")
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r} (expected one of "
                f"{TOPOLOGIES}; 'axiswise' falls back to 'flat' on 1-axis "
                "meshes)")
        if self.route_cap < 0:
            raise ValueError(
                f"route_cap={self.route_cap} is negative (0 = auto, "
                "positive = explicit per-destination capacity)")
        if 0 < self.route_cap < self.slots:
            raise ValueError(
                f"route_cap={self.route_cap} < slots={self.slots}: one "
                "lane sending its whole transaction to a single shard "
                "could never fit, so every wave would drop it — set "
                "route_cap >= slots (or 0 for auto)")
        if self.route_cap % 8:
            raise ValueError(
                f"route_cap={self.route_cap} must be a multiple of 8: the "
                "exchange buffers keep the JAX package's 8-aligned rows "
                "(auto capacity rounds itself)")
        if not 1 <= self.n_groups <= 2:
            raise ValueError(
                f"n_groups={self.n_groups}: the wire meta word packs the "
                "group id into one bit (group | kind << 1 | prio16 << 3)")
        if self.queue_cap < 0:
            raise ValueError(
                f"queue_cap={self.queue_cap} is negative (0 = closed "
                "loop, >= 1 = per-shard admission-ring capacity)")
        if self.max_incarnations < 0:
            raise ValueError(f"max_incarnations must be >= 0, got "
                             f"{self.max_incarnations}")
        if self.queue_cap and self.lat_bins < 2:
            raise ValueError(
                f"lat_bins={self.lat_bins}: the time-to-commit histogram "
                "needs >= 2 bins (the last bin is the overflow bin)")
        if self.max_incarnations and not self.queue_cap:
            raise ValueError(
                f"max_incarnations={self.max_incarnations} shapes the "
                "open-loop admission queue only — set queue_cap >= 1 "
                "(the open-loop switch) to use it")
        if self.max_extent < 1:
            raise ValueError(
                f"max_extent must be >= 1 (1 = point ops), got "
                f"{self.max_extent}")
        if self.max_extent > 0xFFF:
            raise ValueError(
                f"max_extent={self.max_extent} does not fit the wire: the "
                "meta word carries a fragment's scan width in bits 19..30 "
                "(group | kind << 1 | prio16 << 3 | width << 19), so "
                "intervals cap at 4095 records")
        if self.bucket_size < 1:
            raise ValueError(
                f"bucket_size must be >= 1, got {self.bucket_size}")
        if self.max_extent > 1 and self.snapshot_age > 0:
            raise ValueError(
                f"max_extent={self.max_extent} with snapshot_age="
                f"{self.snapshot_age}: interval validation runs against "
                "the CURRENT wave's claim tables, but an aged snapshot "
                "serializes in the past — a scan validated today cannot "
                "protect a cut taken waves ago (the local engine rejects "
                "this identically; EngineConfig)")

    @property
    def open_loop(self) -> bool:
        return self.queue_cap >= 1

    @property
    def is_mv(self) -> bool:
        return self.cc in DIST_MV_CCS

    def cap(self, n_shards: int) -> int:
        """Per-destination buffer capacity: explicit, or 4x the fair share
        (doubled with scans: an op routes up to two fragments), never
        below ``slots``, rounded up to a multiple of 8."""
        if self.route_cap:
            return self.route_cap
        nfrag = 2 if self.max_extent > 1 else 1
        fair = nfrag * self.lanes_per_shard * self.slots / max(n_shards, 1)
        return -(-max(8, int(4 * fair), self.slots) // 8) * 8

    def depth(self, n_shards: int) -> int:
        """Effective pipeline depth: 1 on one shard, else the configured
        ``pipeline_depth``."""
        return 1 if n_shards <= 1 else self.pipeline_depth


def n_shards(group=None) -> int:
    """Shards of the engine: the ranks of ``group`` (None = the default
    process group)."""
    return dist.get_world_size(group)


def _hops(cfg: DistConfig, mesh_shape: Optional[Sequence[int]]) -> int:
    """Collectives one exchange makes: one per mesh axis for the axis-wise
    exchange on a mesh of two or more axes, else one."""
    if (cfg.topology == "axiswise" and mesh_shape is not None
            and len(mesh_shape) > 1):
        return len(mesh_shape)
    return 1


def wire_bytes_per_wave(cfg: DistConfig, ns: int,
                        mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """Bytes one shard hands to the exchange per steady-state wave on
    ``ns`` shards, as the JAX package models them:

    - ``route_bytes_per_wave``: key + meta int32 channels, ``ns * cap * 8``;
    - ``verdict_bytes_per_wave``: the bit-packed verdicts,
      ``ns * verdict_words(cap) * 4``;
    - ``commit_bytes_per_wave``: the packed commit bits, the same;
    - ``verdict_bytes_per_wave_legacy``: one int8 per op, ``ns * cap``;
    - ``wire_bytes_per_wave``: route + verdict + commit.

    The axis-wise exchange on a ``mesh_shape`` of two or more axes sends
    the payload once per axis, so every entry counts that many times.
    """
    cap = cfg.cap(ns)
    W = verdict_words(cap)
    hops = _hops(cfg, mesh_shape)
    route, verdict = ns * cap * 2 * 4, ns * W * 4
    return {"route_bytes_per_wave": route * hops,
            "verdict_bytes_per_wave": verdict * hops,
            "commit_bytes_per_wave": verdict * hops,
            "verdict_bytes_per_wave_legacy": ns * cap * hops,
            "wire_bytes_per_wave": (route + 2 * verdict) * hops}


#: Axis subgroups per (group, mesh shape), built once by every rank
#: (``mesh_groups``) and dropped with the process group
#: (``forget_mesh_groups``).
_MESH_GROUPS: dict = {}


def mesh_groups(mesh_shape: Sequence[int], group=None) -> tuple:
    """One process group per axis of ``mesh_shape`` over ``group``'s ranks
    in row-major order: axis i's group holds the ranks that share every
    other coordinate, ranked by their coordinate along i (the order of
    JAX's ``P((ax0, ax1, ...))``).  Built once per mesh: every rank of the
    default group must make the first call, in the same order, as
    ``torch.distributed.new_group`` asks."""
    shape = tuple(int(d) for d in mesh_shape)
    base = group if group is not None else dist.group.WORLD
    key = (base, shape)
    if key not in _MESH_GROUPS:
        ranks = dist.get_process_group_ranks(base)
        if math.prod(shape) != len(ranks):
            raise ValueError(f"mesh_shape {shape} does not cover the "
                             f"group's {len(ranks)} ranks")
        if ranks != sorted(ranks):
            raise ValueError("mesh_groups needs a group whose ranks rise "
                             "with the global ranks (a subgroup's rank "
                             "order is its global ranks' order)")
        grid = np.asarray(ranks).reshape(shape)
        me = dist.get_rank()
        backend = dist.get_backend(base)
        axes = []
        for i in range(len(shape)):
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            mine = None
            for line in lines:
                g = dist.new_group([int(r) for r in line], backend=backend)
                if me in line:
                    mine = g
            axes.append(mine)
        _MESH_GROUPS[key] = tuple(axes)
    return _MESH_GROUPS[key]


def forget_mesh_groups() -> None:
    """Drop the cached axis subgroups (their process group is gone)."""
    _MESH_GROUPS.clear()


class Exchange:
    """The one collective of the routed wave: ``exchange(buf [ns, B]) ->
    [ns, B]``, where row i goes to rank i and arrived row i came from rank
    i, always in fresh storage.  Flat: one ``all_to_all_single`` over the
    group.  Axis-wise (``axis_groups``, one per axis of ``mesh_shape``):
    the buffer as ``mesh_shape + [B]``, dim i moved to the front and
    exchanged over axis i's group, axis by axis; the row-major composition
    equals the flat exchange.  ``bytes_sent`` and ``calls`` count what
    this rank handed to each collective."""

    def __init__(self, group=None, mesh_shape=None, axis_groups=()):
        if axis_groups:
            self.steps = tuple(enumerate(axis_groups))
            self.shape = tuple(mesh_shape)
        else:
            self.steps = ((0, group),)
            self.shape = None
        self.bytes_sent = 0
        self.calls = 0

    def __call__(self, buf: torch.Tensor) -> torch.Tensor:
        x = buf.reshape((self.shape or buf.shape[:1]) + buf.shape[1:])
        for i, g in self.steps:
            send = x.movedim(i, 0).contiguous()
            out = torch.empty_like(send)
            dist.all_to_all_single(out, send, group=g)
            self.bytes_sent += send.numel() * send.element_size()
            self.calls += 1
            x = out.movedim(0, i)
        return x.reshape(buf.shape)


def _make_exchange(cfg: DistConfig, group,
                   mesh_shape: Optional[Sequence[int]]) -> Exchange:
    if _hops(cfg, mesh_shape) > 1:
        return Exchange(group, mesh_shape, mesh_groups(mesh_shape, group))
    return Exchange(group)


def _check_group(cfg: DistConfig, group, mesh_shape: Optional[Sequence[int]]
                 ) -> int:
    ns = n_shards(group)
    if mesh_shape is not None and math.prod(mesh_shape) != ns:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not "
                         f"cover the group's {ns} ranks")
    return ns


def _make_phases(cfg: DistConfig, ns: int):
    """The four shard-local phases of the routed wave:

    - ``route(keys, groups, kinds, prio) -> (out [ns, 2*cap], send)``:
      ``out`` is the key|meta wire buffer and ``send`` the sender's
      coordinates ``(owner, pos, took, b_lane, lane_dropped, has_write,
      dropped_op, kinds_flat)`` (the kind channel never travels; owner
      and pos are route_pack's, valid where took is set);
    - ``owner_claim(tables, r_buf, wave) -> v_words [ns, W]``;
    - ``sender_commit(send, v_words) -> (commit [T], c_words [ns, W],
      cause [T])``;
    - ``owner_install(tables, r_buf, c_words, wave)``.

    Tables are updated in place.
    """
    cap = cfg.cap(ns)
    rec_per = -(-cfg.n_records // ns)
    T, K, G = cfg.lanes_per_shard, cfg.slots, cfg.n_groups
    fine = cfg.granularity == 1 and G > 1
    be = kb.BACKEND
    mv = cfg.is_mv
    scans = cfg.max_extent > 1
    if scans and cfg.max_extent > rec_per:
        raise ValueError(
            f"max_extent={cfg.max_extent} > rec_per={rec_per}: an "
            "interval may cross at most ONE range-shard boundary (two "
            "fragments) — shrink the interval or the shard count")
    if scans and not fine and rec_per % cfg.bucket_size:
        raise ValueError(
            f"bucket_size={cfg.bucket_size} does not divide rec_per="
            f"{rec_per}: coarse interval validation expands fragments to "
            "bucket boundaries, which must never cross a shard boundary")
    fills = (NO_OP, META_FILL, LANE_FILL)

    def route(keys, groups, kinds, prio):
        dev = keys.device
        kind = (kinds & 3) if scans else kinds
        live = (kind != t.NOP) & (keys >= 0)
        owner = torch.where(live, keys // rec_per, ns)
        lkey = torch.where(live, keys % rec_per, NO_OP)
        # (group | kind | prio16) in one int32 rider word; the lane id never
        # travels.  Scan fragments add their width in bits 19..30.
        meta = (groups | (kind << 1)
                | (prio.to(torch.int32)[:, None].expand(T, K) << 3))
        lane = torch.arange(T, dtype=torch.int32, device=dev)[:, None] \
            .expand(T, K)
        kflat = kinds.reshape(-1)
        if scans:
            # Fragment 1 stays with the start key's owner; fragment 2 (the
            # remainder, possibly empty) starts at row 0 of the next shard.
            ext = torch.clamp(kinds >> 2, min=1)
            is_sc = (kinds >> 2) > 1
            end = torch.minimum(keys + ext, (keys // rec_per + 1) * rec_per)
            w1 = end - keys
            w2 = keys + ext - end
            meta = meta | (torch.where(live & is_sc, w1, 0) << 19)
            live2 = live & is_sc & (w2 > 0)
            owner2 = torch.where(live2, owner + 1, ns)
            lkey2 = torch.where(live2, torch.zeros_like(keys), NO_OP)
            meta2 = torch.where(live2, (meta & ((1 << 19) - 1)) | (w2 << 19),
                                META_FILL)
            owner_f = torch.cat([owner.reshape(-1), owner2.reshape(-1)])
            vals = torch.stack([
                torch.cat([lkey.reshape(-1), lkey2.reshape(-1)]),
                torch.cat([meta.reshape(-1), meta2.reshape(-1)]),
                torch.cat([lane.reshape(-1), lane.reshape(-1)])])
            kflat = torch.cat(
                [kflat, torch.where(live2, kinds, t.NOP).reshape(-1)])
        else:
            owner_f = owner.reshape(-1)
            vals = torch.stack([lkey.reshape(-1), meta.reshape(-1),
                                lane.reshape(-1)])
        buf, pos, took = be.route_pack(owner_f, vals, ns, cap, fills)
        # A capacity-dropped op aborts its lane; took is flat-op aligned,
        # so a reshape and an any reduce it per lane.
        dropped_op = ~took & (owner_f < ns)
        lane_dropped = dropped_op.reshape(-1, T, K).any(dim=2).any(dim=0)
        has_write = (live & ((kind == t.WRITE) | (kind == t.ADD))).any(dim=1)
        out = torch.cat([buf[0], buf[1]], dim=-1)              # [ns, 2*cap]
        send = (owner_f, pos, took, buf[2], lane_dropped, has_write,
                dropped_op, kflat)
        return out, send

    def _decode(r_buf):
        """Arrived [ns, 2*cap] wire buffer -> owner-side op arrays."""
        r_key, r_meta = r_buf[:, :cap], r_buf[:, cap:]
        r_live = r_key != NO_OP
        rk = torch.where(r_live, r_key, -1).contiguous()
        r_grp = (r_meta & 1).contiguous()
        r_kind = (r_meta >> 1) & 3
        r_prio = ((r_meta >> 3) & 0xFFFF).contiguous()
        return rk, r_grp, r_kind, r_prio, r_live, r_meta

    def owner_claim(tables, r_buf, wave: torch.Tensor):
        rk, r_grp, r_kind, r_prio, r_live, r_meta = _decode(r_buf)
        is_w = r_live & ((r_kind == t.WRITE) | (r_kind == t.ADD))
        is_r = r_live & (r_kind == t.READ)
        if scans:
            # Scan fragments leave the point channel and validate their
            # local interval against the post-install claims; the sender
            # classifies their conflicts as phantoms.
            r_w = (r_meta >> 19) & 0xFFF
            is_sc = (r_live & (r_w > 0)).contiguous()
            ext = torch.clamp(r_w, min=1).contiguous()
            is_rp = (is_r & ~is_sc).contiguous()
        else:
            is_rp = is_r.contiguous()
        is_w = is_w.contiguous()
        if not mv:
            # Verdict bit 0: the read was claimed by a stronger lane.
            wts, claim_w = tables
            if cfg.fuse_wave:
                words, _ = be.wave_commit(
                    claim_w, None, None, rk, r_grp, r_prio, is_w, None,
                    is_rp, None, None, None, wave, fine, False, False,
                    pack=True)
            else:
                words = be.claim_probe(claim_w, rk, r_grp, r_prio, wave,
                                       is_w, fine, is_rp=is_rp)
            if scans:
                be.iterate_validate(
                    claim_w, rk, ext, r_grp, r_prio, is_sc, wave, fine,
                    cfg.bucket_size, cfg.max_extent, words=words, bit=0)
        else:
            # claim_w carries every write, claim_r only plain WRITEs (so
            # ADD-ADD pairs commute); reads consult the ring.  Bit 0,
            # unconditional: first-committer-wins write-write (a plain
            # WRITE loses to any stronger writer, an ADD only to a
            # stronger plain WRITE) and snapshot reclamation.  Bit 1, read
            # validation: only MV-OCC applies it, and only to update
            # lanes, which the sender knows.  MVCC's scans read a
            # consistent cut and never re-validate.
            claim_w, claim_r, mv_begin, mv_head = tables
            is_pw = (r_live & (r_kind == t.WRITE)).contiguous()
            words = be.claim_probe(
                claim_w, rk, r_grp, r_prio, wave, is_w, fine,
                claim_r=claim_r, mask_r=is_pw, begin=mv_begin,
                snap_ts=mvstore.snapshot_ts(wave, cfg.snapshot_age),
                is_r=is_r.contiguous(), is_rp=is_rp)
            if scans and cfg.cc == "mvocc":
                be.iterate_validate(
                    claim_w, rk, ext, r_grp, r_prio, is_sc, wave, fine,
                    cfg.bucket_size, cfg.max_extent, words=words, bit=1)
        return words

    def sender_commit(send, v_words):
        # Verdicts are gathered back by each op's routing coordinates: the
        # inverse of route_pack's placement, no scatter; an op that was
        # not taken reads 0.
        (owner_f, pos, took, b_lane, lane_dropped, has_write, dropped_op,
         kind_f) = send
        if scans:
            # The kind channel packs extents; a conflicting scan fragment
            # is a phantom.
            is_sc_f = (kind_f >> 2) > 1
            kind_f = kind_f & 3
        vv = be.verdict_unpack(v_words, cap, owner=owner_f, pos=pos,
                               took=took)
        bit0 = (vv & 1) > 0
        op_conf = bit0
        cause = torch.full_like(kind_f, t.CAUSE_NONE)
        if not mv:
            cause = torch.where(bit0, t.CAUSE_READ_VAL, cause)
            if scans:
                cause = torch.where(bit0 & is_sc_f, t.CAUSE_PHANTOM, cause)
        else:
            if cfg.cc == "mvocc":
                hw_op = has_write[:, None].expand(T, K).reshape(-1)
                if scans:
                    hw_op = torch.cat([hw_op, hw_op])
                rdval = ((vv & 2) > 0) & hw_op
                op_conf = op_conf | rdval
                cause = torch.where(rdval, t.CAUSE_READ_VAL, cause)
                if scans:
                    cause = torch.where(rdval & is_sc_f, t.CAUSE_PHANTOM,
                                        cause)
            # Bit 0 on a write is a first-committer-wins loss, on a read a
            # reclaimed snapshot, which outranks MV-OCC's read validation.
            is_wr = (kind_f == t.WRITE) | (kind_f == t.ADD)
            cause = torch.where(bit0 & is_wr, t.CAUSE_WW, cause)
            cause = torch.where(bit0 & ~is_wr, t.CAUSE_STALE_SNAPSHOT, cause)
        cause = torch.where(dropped_op, t.CAUSE_CAPACITY, cause)
        # Both fragments of an interval must survive; causes min-reduce
        # like any op's.
        commit = ~op_conf.reshape(-1, T, K).any(dim=2).any(dim=0) \
            & ~lane_dropped
        lane_cause = cause.reshape(-1, T, K).amin(dim=(0, 2))
        # Each buffer cell packs its lane's commit bit (an empty cell 0).
        return commit, be.verdict_pack(commit, lane=b_lane), lane_cause

    def owner_install(tables, r_buf, c_words, wave: torch.Tensor):
        # A write bumps where its packed commit field is set; the install
        # launch reads the words itself.
        rk, r_grp, r_kind, _, r_live, _ = _decode(r_buf)
        is_w = (r_live & ((r_kind == t.WRITE) | (r_kind == t.ADD))) \
            .contiguous()
        if not mv:
            be.commit_install(tables[0], rk, r_grp, is_w, words=c_words)
        else:
            be.mv_install(tables[2], tables[3], rk, r_grp, is_w,
                          mvstore.install_ts(wave), words=c_words)

    # Each phase is one profiler range, of the JAX package's names.
    return (in_range("route")(route), in_range("claim")(owner_claim),
            in_range("commit")(sender_commit),
            in_range("install")(owner_install))


def _make_shard_body(cfg: DistConfig, ns: int, exchange: Exchange):
    """The synchronous shard-local wave: route -> claim -> commit ->
    install, three exchanges.  ``body(keys, groups, kinds, prio, tables,
    wave) -> (commit, lane_dropped, has_write, dropped_op, cause)``."""
    route, owner_claim, sender_commit, owner_install = _make_phases(cfg, ns)

    def body(keys, groups, kinds, prio, tables, wave: torch.Tensor):
        out, send = route(keys, groups, kinds, prio)
        r_buf = exchange(out)
        v_words = owner_claim(tables, r_buf, wave)
        commit, c_words, cause = sender_commit(send, exchange(v_words))
        owner_install(tables, r_buf, exchange(c_words), wave)
        _, _, _, _, lane_dropped, has_write, dropped_op, _ = send
        return commit, lane_dropped, has_write, dropped_op, cause

    return body


def _closed_stats(commit, lane_dropped, has_write, dropped_op, cause):
    ro = ~has_write
    head = torch.stack([commit.sum(), (~commit).sum(), lane_dropped.sum(),
                        dropped_op.sum(), (commit & ro).sum(),
                        (~commit & ro).sum()])
    zeros = torch.zeros(4, dtype=head.dtype, device=head.device)
    return torch.cat([head, zeros, t.cause_counts(cause, ~commit)]) \
        .to(torch.int32)


def _pipe_carry_init(cfg: DistConfig, ns: int, device) -> tuple:
    """The empty pipeline carry: three owner-side routed buffers, filled
    with NO_OP keys and META_FILL metas, two verdict/commit word rows of
    zeros and two sender coordinate slots ``(owner, pos, took, b_lane,
    lane_dropped, has_write, dropped_op, kinds_flat)`` with nothing taken,
    so that the warm-up steps' owner and sender phases mask every op and
    write no table.  The flat-op axis M is ``T * K``, doubled with scans
    (two fragments an op).  No two slots share storage."""
    cap, W = cfg.cap(ns), verdict_words(cfg.cap(ns))
    T, K = cfg.lanes_per_shard, cfg.slots
    M = T * K * (2 if cfg.max_extent > 1 else 1)

    def i32(shape, fill):
        return torch.full(shape, fill, dtype=torch.int32, device=device)

    def boolean(n):
        return torch.zeros((n,), dtype=torch.bool, device=device)

    def routed():
        return torch.cat([i32((ns, cap), NO_OP), i32((ns, cap), META_FILL)],
                         dim=-1)

    def coords():
        return (i32((M,), 0), i32((M,), 0), boolean(M),
                i32((ns, cap), LANE_FILL), boolean(T), boolean(T),
                boolean(M), i32((M,), t.NOP))
    return (routed(), routed(), routed(), i32((ns, W), 0), i32((ns, W), 0),
            coords(), coords())


def _nop_wave(cfg: DistConfig, device) -> tuple:
    """One drain wave's (keys, groups, kinds, prio): every slot NOP."""
    T, K = cfg.lanes_per_shard, cfg.slots

    def i32(shape, fill):
        return torch.full(shape, fill, dtype=torch.int32, device=device)
    return i32((T, K), -1), i32((T, K), 0), i32((T, K), t.NOP), i32((T,), 0)


def _make_pipeline_step(cfg: DistConfig, ns: int, exchange: Exchange):
    """One step of the software-pipelined closed loop (module docstring):
    install wave w-3, claim wave w-1, commit wave w-2, route wave w, then
    ONE exchange of ``[O_key | O_meta | V_{w-1} | C_{w-2}]``.
    ``step(carry, keys, groups, kinds, prio, wave) -> (carry, commit,
    stats)``, where ``carry = (tables, rb1, rb2, rb3, v_in, c_in, st1,
    st2)`` and commit and stats are wave w-2's.  ``wave`` is the step's
    0-d int64 device tensor; w-3 and w-1 are derived from it there (their
    low bits, negative in the warm-up steps, are JAX's uint32 wrap)."""
    route, owner_claim, sender_commit, owner_install = _make_phases(cfg, ns)
    cap = cfg.cap(ns)
    W = verdict_words(cap)

    def step(carry, keys, groups, kinds, prio, wave):
        tables, rb1, rb2, rb3, v_in, c_in, st1, st2 = carry
        owner_install(tables, rb3, c_in, wave - 3)
        v_words = owner_claim(tables, rb1, wave - 1)
        commit, c_words, cause = sender_commit(st2, v_in)
        out, st0 = route(keys, groups, kinds, prio)
        arrived = exchange(torch.cat([out, v_words, c_words], dim=-1))
        r_out = arrived[:, :2 * cap].contiguous()
        v_nxt = arrived[:, 2 * cap:2 * cap + W].contiguous()
        c_nxt = arrived[:, 2 * cap + W:].contiguous()
        stats = _closed_stats(commit, st2[4], st2[5], st2[6], cause)
        return ((tables, r_out, rb1, rb2, v_nxt, c_nxt, st0, st1), commit,
                stats)

    return step


def _check_wave_args(cfg: DistConfig, keys, groups, kinds, prio):
    shape = (cfg.lanes_per_shard, cfg.slots)
    for name, x in (("keys", keys), ("groups", groups), ("kinds", kinds)):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape} (lanes_per_shard, slots)")
    if tuple(prio.shape) != shape[:1]:
        raise ValueError(f"prio has shape {tuple(prio.shape)}, expected "
                         f"{shape[:1]}")


def make_wave_fn(cfg: DistConfig, group=None,
                 mesh_shape: Optional[Sequence[int]] = None):
    """The one-wave-per-call synchronous entry point on this rank:
    ``wave(keys, groups, kinds, prio, tables, wave) -> (commit bool[T],
    tables, stats int32[STATS_LEN])``.  ``tables`` (``init_tables``) are
    updated in place and returned.  ``wave.exchange`` counts the bytes
    handed to the collective.  Every rank of ``group`` must call it with
    the same wave index: a 0-d int64 tensor on the tables' device, or an
    int (copied there)."""
    ns = _check_group(cfg, group, mesh_shape)
    if cfg.depth(ns) > 1:
        raise ValueError(
            f"make_wave_fn runs one synchronous wave per call: "
            f"pipeline_depth={cfg.pipeline_depth} on {ns} shards needs the "
            "pipelined runner (make_run_fn; one shard falls back to depth "
            "1)")
    exchange = _make_exchange(cfg, group, mesh_shape)
    body = _make_shard_body(cfg, ns, exchange)

    def wave(keys, groups, kinds, prio, tables, wave_idx):
        _check_wave_args(cfg, keys, groups, kinds, prio)
        commit, lane_dropped, has_write, dropped_op, cause = body(
            keys, groups, kinds, prio, tables,
            device_scalar(wave_idx, keys.device))
        return commit, tables, _closed_stats(commit, lane_dropped, has_write,
                                             dropped_op, cause)

    wave.exchange = exchange
    return wave


def make_run_fn(cfg: DistConfig, n_waves: int, group=None,
                mesh_shape: Optional[Sequence[int]] = None):
    """The closed-loop runner on this rank: ``run(keys [n_waves, T, K],
    groups, kinds, prio [n_waves, T], tables, wave0) -> (commit [n_waves,
    T], tables, stats [n_waves, STATS_LEN])`` for waves ``wave0, wave0 +
    1, ...``, the index advanced on the device.  ``cfg.depth(ns)`` picks
    the schedule, as in the JAX package: depth 1 is a loop of synchronous
    waves (three exchanges a wave), depth >= 2 the software pipeline
    (``_pipelined_run``: one exchange a step, ``n_waves + 3`` steps),
    bit-identical to it.  ``run.exchange`` counts the collective's
    bytes."""
    ns = _check_group(cfg, group, mesh_shape)
    if cfg.depth(ns) > 1:
        return _pipelined_run(cfg, n_waves, group, mesh_shape)
    wave = make_wave_fn(cfg, group, mesh_shape)

    def run(keys, groups, kinds, prio, tables, wave0=0):
        _check_run_args(cfg, n_waves, keys, groups, kinds, prio)
        commits, stats = [], []
        w_idx = device_scalar(wave0, keys.device)
        for w in range(n_waves):
            c, tables, s = wave(keys[w], groups[w], kinds[w], prio[w],
                                tables, w_idx)
            w_idx = w_idx + 1
            commits.append(c)
            stats.append(s)
        return torch.stack(commits), tables, torch.stack(stats)

    run.exchange = wave.exchange
    return run


def _check_run_args(cfg: DistConfig, n_waves: int, keys, groups, kinds,
                    prio) -> None:
    for name, x in (("keys", keys), ("groups", groups), ("kinds", kinds),
                    ("prio", prio)):
        if x.shape[0] != n_waves:
            raise ValueError(f"{name} hold {x.shape[0]} waves, expected "
                             f"{n_waves}")
    if n_waves:
        _check_wave_args(cfg, keys[0], groups[0], kinds[0], prio[0])


def _pipelined_run(cfg: DistConfig, n_waves: int, group=None,
                   mesh_shape: Optional[Sequence[int]] = None):
    """The software-pipelined closed-loop runner at any shard count (the
    depth is not consulted: one rank runs it too), with ``make_run_fn``'s
    signature.  It runs ``n_waves + 3`` steps of ``_make_pipeline_step``,
    the last three on NOP drain waves, and keeps the rows of steps 2 to
    ``n_waves + 1`` (waves 0 to ``n_waves - 1``): the commit, stats and
    final tables of the synchronous loop, bit for bit.  No step waits on
    the host."""
    ns = _check_group(cfg, group, mesh_shape)
    exchange = _make_exchange(cfg, group, mesh_shape)
    step = _make_pipeline_step(cfg, ns, exchange)

    def run(keys, groups, kinds, prio, tables, wave0=0):
        _check_run_args(cfg, n_waves, keys, groups, kinds, prio)
        dev = keys.device
        carry = (tables,) + _pipe_carry_init(cfg, ns, dev)
        drain = _nop_wave(cfg, dev)
        commits, stats = [], []
        w_idx = device_scalar(wave0, dev)
        for s in range(n_waves + 3):
            x = ((keys[s], groups[s], kinds[s], prio[s]) if s < n_waves
                 else drain)
            carry, c, st = step(carry, *x, w_idx)
            w_idx = w_idx + 1
            if 2 <= s < n_waves + 2:
                commits.append(c)
                stats.append(st)
        return torch.stack(commits), carry[0], torch.stack(stats)

    run.exchange = exchange
    return run


class OpenQueue(NamedTuple):
    """One rank's open-loop state, in the JAX package's qstate order: a
    capacity-``queue_cap`` ring of transactions (keys, groups and kinds
    of their K ops, the wave each was admitted, its incarnation and
    admission serial), the ring's cursors and the rank's time-to-commit
    histogram.  int32 throughout, as the JAX package's."""
    q_key: torch.Tensor     # [C, K]
    q_grp: torch.Tensor     # [C, K]
    q_kind: torch.Tensor    # [C, K]
    q_admit: torch.Tensor   # [C]
    q_inc: torch.Tensor     # [C]
    q_id: torch.Tensor      # [C]
    head: torch.Tensor      # [1] ring read cursor
    size: torch.Tensor      # [1] live entries
    next_id: torch.Tensor   # [1] next admission serial
    lat_hist: torch.Tensor  # [lat_bins] time-to-commit in waves


def init_open_queue(cfg: DistConfig, group=None, device=None) -> OpenQueue:
    """This rank's fresh open-loop state for ``make_open_wave_fn``: an
    empty ring and histogram, ``next_id = rank * 2**20`` so that
    admission serials are unique across ranks without coordination (up to
    2**20 admissions a rank)."""
    if not cfg.open_loop:
        raise ValueError("init_open_queue needs queue_cap >= 1")
    dev = resolve_device(device)
    C, K = cfg.queue_cap, cfg.slots

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=dev)
    return OpenQueue(i32(C, K, fill=-1), i32(C, K), i32(C, K, fill=t.NOP),
                     i32(C), i32(C), i32(C), i32(1), i32(1),
                     i32(1, fill=dist.get_rank(group) << 20),
                     i32(cfg.lat_bins))


def _ring_take(C: int, tabs: tuple, head, size, take, lane) -> tuple:
    """Dequeue the first ``take`` ring entries FIFO onto lanes ``[0,
    take)``: ``((keys, groups, kinds, admit_wave, incarnation, txn_id,
    got), head', size')``; the other lanes get empty transactions."""
    qk, qg, qi, qa, qc, qd = tabs
    got = lane < take
    pos = ((head + lane) % C).to(torch.int64)
    g2 = got[:, None]
    picked = (torch.where(g2, qk.index_select(0, pos), -1),
              torch.where(g2, qg.index_select(0, pos), 0),
              torch.where(g2, qi.index_select(0, pos), t.NOP),
              torch.where(got, qa.index_select(0, pos), 0),
              torch.where(got, qc.index_select(0, pos), 0),
              torch.where(got, qd.index_select(0, pos), -1), got)
    return picked, (head + take) % C, size - take


def make_open_wave_fn(cfg: DistConfig, group=None,
                      mesh_shape: Optional[Sequence[int]] = None):
    """The open-loop routed wave on this rank, one wave a call:
    ``open_wave(keys, groups, kinds, prio, n_arrive, tables, qstate,
    wave) -> (commit bool[T], tables, qstate, stats int32[STATS_LEN])``.

    ``keys``/``groups``/``kinds`` [T, K] are this rank's fresh arrival
    candidates, of which the first ``n_arrive`` (an int or a tensor of
    one count) arrive; ``prio`` [T] is the wave's priority of this rank's
    lanes, which the dequeued transactions take.  In order: the arrivals
    enqueue (ring overflow drops them, counted), up to T lanes leave the
    ring FIFO, the shard body runs on them, committed lanes record
    ``wave - admit_wave + 1`` in the histogram, aborted lanes re-enqueue
    with incarnation + 1 or, past ``cfg.max_incarnations``, drop with
    their cause reclassified ``CAUSE_INC_CAP``.  Arrivals land before the
    dequeue frees lanes, so the re-enqueue never overflows.  Stats slots
    6 to 9 carry the wave's admitted arrivals, dropped arrivals, dropped
    incarnations and the ring's occupancy after it.  ``tables`` are
    updated in place, ``qstate`` (``init_open_queue``) is returned anew.
    Every rank calls it with the same wave index."""
    if not cfg.open_loop:
        raise ValueError("make_open_wave_fn needs queue_cap >= 1 (the "
                         "open-loop switch); use make_wave_fn for "
                         "closed-loop waves")
    ns = _check_group(cfg, group, mesh_shape)
    if cfg.depth(ns) > 1:
        raise ValueError(
            f"make_open_wave_fn runs one synchronous wave per call: "
            f"pipeline_depth={cfg.pipeline_depth} on {ns} shards needs the "
            "pipelined open-loop runner (run_open_loop; one shard falls "
            "back to depth 1)")
    exchange = _make_exchange(cfg, group, mesh_shape)
    body = _make_shard_body(cfg, ns, exchange)
    T, C = cfg.lanes_per_shard, cfg.queue_cap

    def open_wave(keys, groups, kinds, prio, n_arrive, tables, qstate,
                  wave_idx):
        _check_wave_args(cfg, keys, groups, kinds, prio)
        dev = keys.device
        wave = device_scalar(wave_idx, dev)
        w = wave.to(torch.int32)
        (qk, qg, qi, qa, qc, qd, head, size, nid, lat_hist) = qstate
        lane = torch.arange(T, dtype=torch.int32, device=dev)
        zeros = torch.zeros((T,), dtype=torch.int32, device=dev)

        # Arrivals: the first n_arrive fresh lanes enter the ring.
        n_arr = torch.as_tensor(n_arrive, device=dev).to(torch.int32) \
            .reshape(-1)[:1].clamp(max=T)
        (qk, qg, qi, qa, qc, qd), size, n_adm, n_ovf = \
            admission.ring_enqueue(
                C, head, size, lane < n_arr, (qk, qg, qi, qa, qc, qd),
                (keys, groups, kinds, w.expand(T), zeros, nid + lane))

        # Admit: fill the rank's T lanes FIFO.
        (dk, dg, di, admit_w, incarn, txn_id, got), head, size = _ring_take(
            C, (qk, qg, qi, qa, qc, qd), head, size, size.clamp(max=T),
            lane)

        # The routed wave on the admitted lanes.
        commit, lane_dropped, has_write, dropped_op, cause = body(
            dk, dg, di, prio, tables, wave)
        commit = commit & got
        aborted = got & ~commit

        # Retry incarnations and time-to-commit.
        retry = aborted & (incarn < cfg.max_incarnations)
        inc_drop = aborted & ~retry
        cause = torch.where(inc_drop, t.CAUSE_INC_CAP, cause)
        (qk, qg, qi, qa, qc, qd), size, _, n_re_ovf = \
            admission.ring_enqueue(
                C, head, size, retry, (qk, qg, qi, qa, qc, qd),
                (dk, dg, di, admit_w, incarn + 1, txn_id))
        lat_hist = admission.record_ttc(lat_hist, w - admit_w + 1, commit)

        ro = ~has_write
        head_stats = torch.stack([
            commit.sum(), aborted.sum(), lane_dropped.sum(),
            dropped_op.sum(), (commit & ro).sum(), (aborted & ro).sum(),
            n_adm, n_ovf + n_re_ovf, inc_drop.sum(), size[0].long()])
        stats = torch.cat([head_stats, t.cause_counts(cause, aborted)]) \
            .to(torch.int32)
        return commit, tables, OpenQueue(
            qk, qg, qi, qa, qc, qd, head, size, nid + n_arr,
            lat_hist), stats

    open_wave.exchange = exchange
    return open_wave


def _open_slot(cfg: DistConfig, device) -> tuple:
    """An empty sender-side admission slot of the open pipeline: (keys,
    groups, kinds, admit_wave, incarnation, got, txn_id, admitted,
    arrival drops) of a wave that dequeued nothing."""
    T, K = cfg.lanes_per_shard, cfg.slots

    def i32(shape, fill):
        return torch.full(shape, fill, dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return (i32((T, K), -1), i32((T, K), 0), i32((T, K), t.NOP),
            i32((T,), 0), i32((T,), 0),
            torch.zeros((T,), dtype=torch.bool, device=device),
            i32((T,), -1), zero, zero.clone())


def _make_open_pipeline_step(cfg: DistConfig, ns: int, exchange: Exchange):
    """One step of the software-pipelined open loop: the closed pipeline's
    schedule with this rank's admission ring in the carry.  Wave w-2's
    verdicts land this step, so its aborted lanes re-enqueue two waves
    after they ran, before wave w's arrivals.  With two waves in flight
    the ring may be full: a retry it rejects leaves as an incarnation
    drop (counted in ``inc_drops``, keeping its validation cause), so
    ``admitted == commits + queued_final + inc_drops`` stays exact.
    ``step(carry, keys, groups, kinds, prio, n_arrive, wave, live) ->
    (carry, commit, stats)``, ``carry = (tables, rb1, rb2, rb3, v_in,
    c_in, st1, st2, os1, os2, qstate)``; the stats row is wave w-2's, its
    admission counters carried in the ``os`` slots from the step that
    admitted it.  A drain step (``live`` False) admits and dequeues
    nothing."""
    route, owner_claim, sender_commit, owner_install = _make_phases(cfg, ns)
    cap = cfg.cap(ns)
    W = verdict_words(cap)
    T, C = cfg.lanes_per_shard, cfg.queue_cap

    def step(carry, keys, groups, kinds, prio, n_arrive, wave, live):
        (tables, rb1, rb2, rb3, v_in, c_in, st1, st2, os1, os2,
         qstate) = carry
        (qk, qg, qi, qa, qc, qd, head, size, nid, lat_hist) = qstate
        dev = keys.device
        lane = torch.arange(T, dtype=torch.int32, device=dev)

        # Owner phases: install wave w-3, claim wave w-1.
        owner_install(tables, rb3, c_in, wave - 3)
        v_words = owner_claim(tables, rb1, wave - 1)

        # Sender: wave w-2's fate, its retries and time-to-commit.
        commit, c_words, cause = sender_commit(st2, v_in)
        dk2, dg2, di2, admit2, inc2, got2, qid2, n_adm2, n_ovf2 = os2
        commit = commit & got2
        aborted = got2 & ~commit
        retry = aborted & (inc2 < cfg.max_incarnations)
        cause = torch.where(aborted & ~retry, t.CAUSE_INC_CAP, cause)
        (qk, qg, qi, qa, qc, qd), size, _, n_re_ovf = \
            admission.ring_enqueue(
                C, head, size, retry, (qk, qg, qi, qa, qc, qd),
                (dk2, dg2, di2, admit2, inc2 + 1, qid2))
        inc_drop = (aborted & ~retry).sum() + n_re_ovf
        w = wave.to(torch.int32)
        lat_hist = admission.record_ttc(lat_hist, w - 2 - admit2 + 1,
                                        commit)

        # Wave w's arrivals, then its lanes FIFO (none on a drain step).
        n_arr = n_arrive.reshape(-1)[:1].to(torch.int32).clamp(max=T)
        (qk, qg, qi, qa, qc, qd), size, n_adm, n_ovf = \
            admission.ring_enqueue(
                C, head, size, lane < n_arr, (qk, qg, qi, qa, qc, qd),
                (keys, groups, kinds, w.expand(T), torch.zeros_like(lane),
                 nid + lane))
        nid = nid + n_arr
        take = size.clamp(max=T) if live else torch.zeros_like(size)
        (dk, dg, di, admit_w, incarn, qid, got), head, size = _ring_take(
            C, (qk, qg, qi, qa, qc, qd), head, size, take, lane)

        # Route wave w; ONE exchange.
        out, st0 = route(dk, dg, di, prio)
        arrived = exchange(torch.cat([out, v_words, c_words], dim=-1))
        r_out = arrived[:, :2 * cap].contiguous()
        v_nxt = arrived[:, 2 * cap:2 * cap + W].contiguous()
        c_nxt = arrived[:, 2 * cap + W:].contiguous()

        ro = ~st2[5]
        head_stats = torch.stack([
            commit.sum(), aborted.sum(), st2[4].sum(), st2[6].sum(),
            (commit & ro).sum(), (aborted & ro).sum(), n_adm2, n_ovf2,
            inc_drop, size[0].long()])
        stats = torch.cat([head_stats, t.cause_counts(cause, aborted)]) \
            .to(torch.int32)
        os0 = (dk, dg, di, admit_w, incarn, got, qid, n_adm, n_ovf)
        qstate = OpenQueue(qk, qg, qi, qa, qc, qd, head, size, nid,
                           lat_hist)
        return ((tables, r_out, rb1, rb2, v_nxt, c_nxt, st0, st1, os0, os1,
                 qstate), commit, stats)

    return step


def _open_pipelined_run(cfg: DistConfig, n_waves: int, group=None,
                        mesh_shape: Optional[Sequence[int]] = None):
    """The software-pipelined open-loop runner at any shard count (the
    depth is not consulted), with ``make_open_run_fn``'s signature: it
    runs ``n_waves + 3`` steps, the three drain steps admitting and
    dequeuing nothing, and keeps the rows of waves 0 to ``n_waves - 1``.
    No step waits on the host."""
    ns = _check_group(cfg, group, mesh_shape)
    exchange = _make_exchange(cfg, group, mesh_shape)
    step = _make_open_pipeline_step(cfg, ns, exchange)

    def run(keys, groups, kinds, prio, n_arrive, tables, qstate, wave0=0):
        _check_run_args(cfg, n_waves, keys, groups, kinds, prio)
        if n_arrive.shape[0] != n_waves:
            raise ValueError(f"n_arrive holds {n_arrive.shape[0]} waves, "
                             f"expected {n_waves}")
        dev = keys.device
        n_arrive = n_arrive.to(dev)
        carry = ((tables,) + _pipe_carry_init(cfg, ns, dev)
                 + (_open_slot(cfg, dev), _open_slot(cfg, dev),
                    OpenQueue(*qstate)))
        drain = _nop_wave(cfg, dev)
        none = torch.zeros((1,), dtype=torch.int32, device=dev)
        commits, stats = [], []
        w_idx = device_scalar(wave0, dev)
        for s in range(n_waves + 3):
            live = s < n_waves
            x = ((keys[s], groups[s], kinds[s], prio[s], n_arrive[s])
                 if live else drain + (none,))
            carry, c, st = step(carry, *x, w_idx, live)
            w_idx = w_idx + 1
            if 2 <= s < n_waves + 2:
                commits.append(c)
                stats.append(st)
        return (torch.stack(commits), carry[0], carry[-1],
                torch.stack(stats))

    run.exchange = exchange
    return run


def make_open_run_fn(cfg: DistConfig, n_waves: int, group=None,
                     mesh_shape: Optional[Sequence[int]] = None):
    """The pipelined open-loop runner (effective depth >= 2) on this rank:
    ``run(keys [n_waves, T, K], groups, kinds, prio [n_waves, T],
    n_arrive [n_waves], tables, qstate, wave0) -> (commit [n_waves, T],
    tables, qstate, stats [n_waves, STATS_LEN])``; ``n_arrive`` holds this
    rank's arrival counts.  At depth 1 ``run_open_loop`` runs
    ``make_open_wave_fn`` wave by wave, as the JAX package's does."""
    if not cfg.open_loop:
        raise ValueError("make_open_run_fn needs queue_cap >= 1 (the "
                         "open-loop switch)")
    ns = _check_group(cfg, group, mesh_shape)
    if cfg.depth(ns) < 2:
        raise ValueError(
            "make_open_run_fn is the pipelined runner: effective depth "
            f"{cfg.depth(ns)} on {ns} shards runs the synchronous "
            "make_open_wave_fn instead (run_open_loop picks)")
    return _open_pipelined_run(cfg, n_waves, group, mesh_shape)


def run_open_loop(cfg: DistConfig, arrive_counts, gen_fn: Callable,
                  n_waves: int, group=None, device=None,
                  mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """Run ``n_waves`` open waves on every rank of ``group`` and reconcile
    the ranks' stats into the JAX package's summary dict.

    ``arrive_counts`` is int[n_waves, n_shards]
    (``PoissonArrivals.shard_counts``); ``gen_fn(wave) -> (keys, groups,
    kinds, prio)`` gives the wave's globally shaped candidates ([n_shards
    * T, K], prio [n_shards * T]; numpy arrays or tensors), of which each
    rank takes its own lanes.  Tables and queues start fresh on
    ``device`` (CUDA unless the caller asks for the CPU).  The effective
    depth picks the engine, as in the JAX package: a loop of
    ``make_open_wave_fn`` waves at depth 1, the pipelined runner at depth
    >= 2 (retries re-enqueue two waves later and may drop into
    ``inc_drops``).  The summary holds the identities that the
    conservation oracle asserts, exactly, at every depth: ``admitted ==
    commits + queued_final + inc_drops`` and ``offered == admitted +
    arrival_drops``; ``lat_hist`` is int[n_shards, lat_bins],
    ``per_shard_stats`` int64[n_shards, STATS_LEN].  It adds ``wall_s``,
    the host seconds of the waves and their candidates up to a device
    synchronize, and ``exchange_bytes``, what this rank handed to the
    collective."""
    ns = _check_group(cfg, group, mesh_shape)
    return _open_loop(cfg, arrive_counts, gen_fn, n_waves, group, device,
                      mesh_shape, cfg.depth(ns))


def _open_loop(cfg: DistConfig, arrive_counts, gen_fn: Callable,
               n_waves: int, group, device, mesh_shape, depth: int) -> dict:
    """``run_open_loop`` at an explicit ``depth`` (1: the synchronous
    waves; >= 2: ``_open_pipelined_run``, on one rank too)."""
    ns = _check_group(cfg, group, mesh_shape)
    dev = resolve_device(device)
    T = cfg.lanes_per_shard
    rank = dist.get_rank(group)
    mine = slice(rank * T, (rank + 1) * T)
    counts = np.asarray(arrive_counts).reshape(n_waves, ns)
    tables = init_tables(cfg, group, dev)
    qstate = init_open_queue(cfg, group, dev)

    def local(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x).astype(np.int32))
        return x[mine].to(dev, torch.int32).contiguous()

    def gather(x):
        out = [torch.zeros_like(x) for _ in range(ns)]
        dist.all_gather(out, x, group=group)
        return torch.stack(out).cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if depth >= 2:
        run = _open_pipelined_run(cfg, n_waves, group, mesh_shape)
        draws = [[local(x) for x in gen_fn(w)] for w in range(n_waves)]
        stacked = (torch.stack(col) for col in zip(*draws))
        n_arr = torch.from_numpy(counts[:, rank].astype(np.int32)).to(dev)
        _, tables, qstate, stats = run(*stacked, n_arr, tables, qstate)
        acc = stats.to(torch.int64).sum(dim=0)
        exchange = run.exchange
    else:
        wave = make_open_wave_fn(cfg, group, mesh_shape)
        acc = torch.zeros((STATS_LEN,), dtype=torch.int64, device=dev)
        w_idx = device_scalar(0, dev)
        for w in range(n_waves):
            keys, groups, kinds, prio = (local(x) for x in gen_fn(w))
            _, tables, qstate, stats = wave(keys, groups, kinds, prio,
                                            int(counts[w, rank]), tables,
                                            qstate, w_idx)
            acc += stats
            w_idx = w_idx + 1
        exchange = wave.exchange
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    acc_np = gather(acc)
    return {
        "commits": int(acc_np[:, STAT_COMMITS].sum()),
        "aborts": int(acc_np[:, STAT_ABORTS].sum()),
        "ro_commits": int(acc_np[:, STAT_RO_COMMITS].sum()),
        "ro_aborts": int(acc_np[:, STAT_RO_ABORTS].sum()),
        "offered": int(np.minimum(counts, T).sum()),
        "admitted": int(acc_np[:, STAT_ADMITTED].sum()),
        "arrival_drops": int(acc_np[:, STAT_ARRIVAL_DROPS].sum()),
        "inc_drops": int(acc_np[:, STAT_INC_DROPS].sum()),
        "queued_final": int(gather(qstate.size).sum()),
        "abort_causes": [int(x) for x in acc_np[:, STAT_CAUSES].sum(axis=0)],
        "lat_hist": gather(qstate.lat_hist),
        "per_shard_stats": acc_np,
        "wall_s": wall_s,
        "exchange_bytes": exchange.bytes_sent,
    }


def init_tables(cfg: DistConfig, group=None, device=None) -> tuple:
    """Fresh tables of this rank's ``rec_per`` records (the record space
    padded to ``n_shards * rec_per``), on ``device`` (CUDA by default):

    - occ:         ``(wts, claim_w)``, int32[rec_per, G] word tables;
    - mvcc/mvocc:  ``(claim_w, claim_r, mv_begin, mv_head)``, the version
      ring of core/mvstore.py (slot 0 live at begin 0, head 0).
    """
    dev = resolve_device(device)
    rec_per = -(-cfg.n_records // n_shards(group))
    G = cfg.n_groups
    claim_w = torch.full((rec_per, G), -1, dtype=torch.int32, device=dev)
    if cfg.is_mv:
        mv_begin, mv_head, _ = mvstore.mv_init(rec_per, cfg.mv_depth, G, dev)
        return (claim_w, claim_w.clone(), mv_begin, mv_head)
    return (torch.zeros((rec_per, G), dtype=torch.int32, device=dev),
            claim_w)
