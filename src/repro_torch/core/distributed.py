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

Not ported yet, raising NotImplementedError with their ROADMAP item: the
software pipeline (``pipeline_depth >= 2`` on more than one shard), the
axis-wise exchange on meshes of two or more axes, and the open loop
(``queue_cap >= 1``, ``make_open_wave_fn``, ``run_open_loop``).  Values
are not tracked on the sharded path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

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

_PIPELINE = "ROADMAP A.11 (pipeline_depth >= 2: the software pipeline)"
_AXISWISE = ("ROADMAP A.11 (topology='axiswise': DeviceMesh subgroups, one "
             "exchange per mesh axis)")
_OPEN_LOOP = "ROADMAP A.11 (the sharded open loop, after A.9)"


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
        if self.open_loop:
            raise NotImplementedError(
                f"queue_cap={self.queue_cap} (the open loop) is not ported "
                f"to repro_torch yet: it waits for {_OPEN_LOOP}")

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


def wire_bytes_per_wave(cfg: DistConfig, ns: int) -> dict:
    """Bytes one shard hands to the exchange per synchronous wave on
    ``ns`` shards (the flat exchange):

    - ``route_bytes_per_wave``: key + meta int32 channels, ``ns * cap * 8``;
    - ``verdict_bytes_per_wave``: the bit-packed verdicts,
      ``ns * verdict_words(cap) * 4``;
    - ``commit_bytes_per_wave``: the packed commit bits, the same;
    - ``verdict_bytes_per_wave_legacy``: one int8 per op, ``ns * cap``;
    - ``wire_bytes_per_wave``: route + verdict + commit.
    """
    cap = cfg.cap(ns)
    W = verdict_words(cap)
    route, verdict = ns * cap * 2 * 4, ns * W * 4
    return {"route_bytes_per_wave": route,
            "verdict_bytes_per_wave": verdict,
            "commit_bytes_per_wave": verdict,
            "verdict_bytes_per_wave_legacy": ns * cap,
            "wire_bytes_per_wave": route + 2 * verdict}


class Exchange:
    """The one collective of the routed wave: ``exchange(buf [ns, B]) ->
    [ns, B]``, one ``all_to_all_single`` over the group, where row i goes
    to rank i and arrived row i came from rank i.  ``bytes_sent`` and
    ``calls`` count what this rank handed to the collective."""

    def __init__(self, group=None):
        self.group = group
        self.bytes_sent = 0
        self.calls = 0

    def __call__(self, buf: torch.Tensor) -> torch.Tensor:
        buf = buf.contiguous()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self.group)
        self.bytes_sent += buf.numel() * buf.element_size()
        self.calls += 1
        return out


def _check_group(cfg: DistConfig, group, mesh_shape: Optional[Sequence[int]]
                 ) -> int:
    ns = n_shards(group)
    if mesh_shape is not None:
        if math.prod(mesh_shape) != ns:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not "
                             f"cover the group's {ns} ranks")
        if cfg.topology == "axiswise" and len(mesh_shape) > 1:
            raise NotImplementedError(
                f"topology='axiswise' on a {len(mesh_shape)}-axis mesh is "
                f"not ported to repro_torch yet: it waits for {_AXISWISE}")
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
            "scanned runner (make_run_fn; one shard falls back to depth 1)")
    exchange = Exchange(group)
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
    T], tables, stats [n_waves, STATS_LEN])``, a loop of synchronous waves
    ``wave0, wave0 + 1, ...``, the index advanced on the device.
    ``run.exchange`` counts the collective's bytes."""
    ns = _check_group(cfg, group, mesh_shape)
    if cfg.depth(ns) > 1:
        raise NotImplementedError(
            f"pipeline_depth={cfg.pipeline_depth} on {ns} shards is not "
            f"ported to repro_torch yet: it waits for {_PIPELINE}")
    wave = make_wave_fn(cfg, group, mesh_shape)

    def run(keys, groups, kinds, prio, tables, wave0=0):
        if keys.shape[0] != n_waves:
            raise ValueError(f"keys hold {keys.shape[0]} waves, expected "
                             f"{n_waves}")
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


def make_open_wave_fn(cfg: DistConfig, group=None, mesh_shape=None):
    raise NotImplementedError(
        "make_open_wave_fn (the sharded open loop) is not ported to "
        f"repro_torch yet: it waits for {_OPEN_LOOP}")


def run_open_loop(cfg: DistConfig, *args, **kwargs):
    raise NotImplementedError(
        "run_open_loop (the sharded open loop) is not ported to "
        f"repro_torch yet: it waits for {_OPEN_LOOP}")


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
