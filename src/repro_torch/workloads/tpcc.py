"""TPC-C (New-order, Payment, Order-status — 92% of the standard mix, the
three the paper implements; ``scan_len > 0`` adds a Stock-level-style
fourth type and turns Order-status's order-line reads into one interval
scan), laid out for wave execution (port of ``repro/workloads/tpcc.py``).

Tables live in one flat record space:

    Warehouse | District | Customer | Item | Stock | Order ring | OrderLine ring

New-order READS the warehouse/district tax fields while Payment UPDATES
the YTD fields of the same rows: with one timestamp per row these are
false conflicts, the paper's central observation.  Fine granularity gives
W/D/C rows two timestamps (group 0 = rarely-updated fields, group 1 = the
rest).  YTD/balance updates are blind commutative ADDs; order ids and
insert slots come from per-district append rings whose cursors advance by
a wave prefix sum, outside CC.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import types as t
from repro_torch.core.types import StoreState, TxnBatch, store_init
from repro_torch.workloads.zipf import nurand

NEW_ORDER, PAYMENT, ORDER_STATUS, STOCK_LEVEL = 0, 1, 2, 3
# Renormalized standard mix (45/43/4 out of the 92% the paper implements).
MIX = (45 / 92, 43 / 92, 4 / 92)
# With the scan classes on (scan_len > 0): Stock-level joins at its
# standard 4% weight, 45/43/4/4 renormalized.
MIX_SCAN = (45 / 96, 43 / 96, 4 / 96, 4 / 96)

MAX_ITEMS = 15
SLOTS = 64

# Column layout (n_cols = 4).
W_TAX, W_YTD = 0, 1
D_TAX, D_YTD = 0, 1
C_INFO, C_BAL, C_YTD, C_CNT = 0, 1, 2, 3
S_QTY = 0

# Fine-granularity groups for W/D/C rows (the paper's two timestamps).
G_RARE, G_HOT = 0, 1


@dataclasses.dataclass(frozen=True)
class TPCCWorkload:
    n_warehouses: int = 8
    n_districts: int = 10
    n_cust_per_d: int = 3000
    n_items: int = 100_000
    o_cap: int = 1024
    #: 0 = the three-type point-op mix.  > 0 turns on the scan classes:
    #: Order-status reads its order lines as ONE interval of extent
    #: MAX_ITEMS (the keys are consecutive), and a Stock-level type scans
    #: ``scan_len`` consecutive stock rows of the home warehouse.
    scan_len: int = 0

    n_groups: int = 2
    n_txn_types: int = 3

    def __post_init__(self):
        if self.scan_len > 0:
            if self.scan_len > self.n_items:
                raise ValueError(
                    f"scan_len {self.scan_len} exceeds n_items "
                    f"{self.n_items}")
            if self.n_txn_types < 4:
                object.__setattr__(self, "n_txn_types", 4)

    @staticmethod
    def make(n_warehouses: int = 8, scale: float = 1.0,
             scan_len: int = 0) -> "TPCCWorkload":
        """scale < 1 shrinks the per-warehouse tables (for tests)."""
        return TPCCWorkload(
            n_warehouses=n_warehouses,
            n_cust_per_d=max(int(3000 * scale), 8),
            n_items=max(int(100_000 * scale), 16),
            o_cap=max(int(1024 * scale), 16),
            scan_len=scan_len,
        )

    # ---- layout ----
    @property
    def n_dist_total(self) -> int:
        return self.n_warehouses * self.n_districts

    @property
    def d_base(self) -> int:
        return self.n_warehouses

    @property
    def c_base(self) -> int:
        return self.d_base + self.n_dist_total

    @property
    def i_base(self) -> int:
        return self.c_base + self.n_dist_total * self.n_cust_per_d

    @property
    def s_base(self) -> int:
        return self.i_base + self.n_items

    @property
    def o_base(self) -> int:
        return self.s_base + self.n_warehouses * self.n_items

    @property
    def ol_base(self) -> int:
        return self.o_base + self.n_dist_total * self.o_cap

    @property
    def n_records(self) -> int:
        return self.ol_base + self.n_dist_total * self.o_cap * MAX_ITEMS

    @property
    def n_cols(self) -> int:
        return 4

    @property
    def n_rings(self) -> int:
        return self.n_dist_total

    @property
    def slots(self) -> int:
        return SLOTS

    @property
    def max_extent(self) -> int:
        """Widest interval an op carries: the order-line scan (MAX_ITEMS)
        or the Stock-level window; 1 without scans."""
        return max(MAX_ITEMS, self.scan_len) if self.scan_len > 0 else 1

    def init_store(self, device=None, mv_depth: int = 0,
                   track_values: bool = False) -> StoreState:
        """A fresh store; ``track_values`` gives it the record values
        (``n_cols`` columns, zeros)."""
        return store_init(self.n_records, self.n_groups,
                          n_rings=self.n_rings, device=device,
                          mv_depth=mv_depth,
                          n_cols=self.n_cols if track_values else 0)

    # ---- key helpers ----
    def d_key(self, w, d):
        return self.d_base + w * self.n_districts + d

    def c_key(self, w, d, c):
        return (self.c_base
                + (w * self.n_districts + d) * self.n_cust_per_d + c)

    def s_key(self, w, i):
        return self.s_base + w * self.n_items + i

    def o_key(self, r, pos):
        return self.o_base + r * self.o_cap + pos

    def ol_key(self, r, pos, j):
        return self.ol_base + (r * self.o_cap + pos) * MAX_ITEMS + j

    # ---- generation ----
    def gen(self, gen: torch.Generator, wave: int, lanes: int,
            ring_tails: torch.Tensor):
        dev = ring_tails.device
        T = lanes

        def randint(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=gen, device=dev)

        mix = _mix(MIX_SCAN if self.scan_len > 0 else MIX, dev)
        txn_type = torch.multinomial(mix, T, replacement=True,
                                     generator=gen).to(torch.int32)
        w = randint(0, self.n_warehouses, (T,))
        d = randint(0, self.n_districts, (T,))
        c = nurand(gen, 1023, 0, self.n_cust_per_d - 1, 259, (T,), dev)
        items = nurand(gen, 8191, 0, self.n_items - 1, 7911,
                       (T, MAX_ITEMS), dev) % self.n_items
        n_it = randint(5, MAX_ITEMS + 1, (T,))
        qty = randint(1, 11, (T, MAX_ITEMS)).to(torch.float32)

        # Payment: 15% remote customer (different warehouse + district).
        remote = torch.rand((T,), generator=gen, device=dev) < 0.15
        rw_ = randint(0, self.n_warehouses, (T,))
        rd_ = randint(0, self.n_districts, (T,))
        c_w = torch.where(remote, rw_, w)
        c_d = torch.where(remote, rd_, d)

        # Ring slot assignment for New-order lanes: per-district prefix sums.
        ring = w * self.n_districts + d
        is_no = txn_type == NEW_ORDER
        onehot = ((ring[:, None]
                   == torch.arange(self.n_dist_total, device=dev)[None, :])
                  & is_no[:, None])
        rank = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
        my_rank = rank.gather(1, ring[:, None])[:, 0]
        tails64 = ring_tails.to(torch.int64)
        o_pos = (tails64[ring] + my_rank) % self.o_cap
        new_tails = (ring_tails
                     + onehot.sum(dim=0).to(torch.int32)).to(torch.int32)

        variants = [
            self._gen_new_order(T, dev, w, d, c, items, n_it, qty, ring,
                                o_pos),
            self._gen_payment(T, dev, w, d, c_w, c_d, c),
            self._gen_order_status(T, dev, w, d, c, ring, tails64),
        ]
        if self.scan_len > 0:
            i0 = randint(0, self.n_items - self.scan_len + 1, (T,))
            variants.append(self._gen_stock_level(T, dev, w, d, i0))
        lane = torch.arange(T, device=dev)
        sel = txn_type.to(torch.int64)
        out = {}
        for f in dataclasses.fields(TxnBatch):
            stacked = torch.stack([getattr(v, f.name) for v in variants])
            out[f.name] = stacked[sel, lane]
        out["txn_type"] = txn_type
        return TxnBatch(**out), new_tails

    def _empty(self, T, dev):
        def zi():
            return torch.zeros((T, SLOTS), dtype=torch.int32, device=dev)
        return dict(
            op_key=torch.full((T, SLOTS), -1, dtype=torch.int32, device=dev),
            op_group=zi(), op_col=zi(), op_kind=zi(),
            op_val=torch.zeros((T, SLOTS), dtype=torch.float32, device=dev),
            op_extent=torch.ones((T, SLOTS), dtype=torch.int32, device=dev),
        )

    @staticmethod
    def _set(f, sl, key, col, kind, group, val=0.0, mask=None):
        key = key.to(torch.int32)
        if mask is not None:
            key = torch.where(mask, key, -1)
        f["op_key"][:, sl] = key
        f["op_col"][:, sl] = col
        f["op_kind"][:, sl] = kind
        f["op_group"][:, sl] = group
        f["op_val"][:, sl] = val

    def _batch(self, f, T, dev, txn_type, n_ops):
        return TxnBatch(
            txn_type=torch.full((T,), txn_type, dtype=torch.int32,
                                device=dev),
            n_ops=n_ops.to(torch.int32), **f)

    def _gen_new_order(self, T, dev, w, d, c, items, n_it, qty, ring, o_pos):
        f = self._empty(T, dev)
        jmask = (torch.arange(MAX_ITEMS, device=dev)[None, :]
                 < n_it[:, None])
        self._set(f, 0, w, W_TAX, t.READ, G_RARE)
        self._set(f, 1, self.d_key(w, d), D_TAX, t.READ, G_RARE)
        self._set(f, 2, self.c_key(w, d, c), C_INFO, t.READ, G_RARE)
        self._set(f, slice(3, 18), self.i_base + items, 0, t.READ, G_RARE,
                  mask=jmask)
        skeys = self.s_key(w[:, None], items)
        self._set(f, slice(18, 33), skeys, S_QTY, t.READ, G_RARE, mask=jmask)
        self._set(f, slice(33, 48), skeys, S_QTY, t.WRITE, G_RARE, val=qty,
                  mask=jmask)
        self._set(f, 48, self.o_key(ring, o_pos), 0, t.WRITE, G_RARE,
                  val=c.to(torch.float32))
        olk = self.ol_key(ring[:, None], o_pos[:, None],
                          torch.arange(MAX_ITEMS, device=dev)[None, :])
        self._set(f, slice(49, 64), olk, 0, t.WRITE, G_RARE,
                  val=items.to(torch.float32), mask=jmask)
        return self._batch(f, T, dev, NEW_ORDER, 4 + 3 * n_it)

    def _gen_payment(self, T, dev, w, d, c_w, c_d, c):
        f = self._empty(T, dev)
        ck = self.c_key(c_w, c_d, c)
        one = torch.ones((T,), dtype=torch.float32, device=dev)
        self._set(f, 0, w, W_YTD, t.ADD, G_HOT, val=one)
        self._set(f, 1, self.d_key(w, d), D_YTD, t.ADD, G_HOT, val=one)
        self._set(f, 2, ck, C_INFO, t.READ, G_RARE)
        self._set(f, 3, ck, C_BAL, t.ADD, G_HOT, val=-one)
        self._set(f, 4, ck, C_YTD, t.ADD, G_HOT, val=one)
        self._set(f, 5, ck, C_CNT, t.ADD, G_HOT, val=one)
        return self._batch(f, T, dev, PAYMENT,
                           torch.full((T,), 6, device=dev))

    def _gen_order_status(self, T, dev, w, d, c, ring, ring_tails):
        f = self._empty(T, dev)
        ck = self.c_key(w, d, c)
        last = (ring_tails[ring] - 1) % self.o_cap
        self._set(f, 0, ck, C_INFO, t.READ, G_RARE)
        self._set(f, 1, ck, C_BAL, t.READ, G_HOT)
        self._set(f, 2, self.o_key(ring, last), 0, t.READ, G_RARE)
        if self.scan_len > 0:
            # The order's MAX_ITEMS order-line keys are consecutive, so
            # the point reads collapse into ONE interval scan.
            self._set(f, 3, self.ol_key(ring, last, 0), 0, t.READ, G_RARE)
            f["op_extent"][:, 3] = MAX_ITEMS
            n_ops = 4
        else:
            olk = self.ol_key(ring[:, None], last[:, None],
                              torch.arange(MAX_ITEMS, device=dev)[None, :])
            self._set(f, slice(3, 18), olk, 0, t.READ, G_RARE)
            n_ops = 18
        return self._batch(f, T, dev, ORDER_STATUS,
                           torch.full((T,), n_ops, device=dev))

    def _gen_stock_level(self, T, dev, w, d, i0):
        """Stock-level style: read the district, then scan ``scan_len``
        consecutive stock rows of the home warehouse.  Read-only."""
        f = self._empty(T, dev)
        self._set(f, 0, self.d_key(w, d), D_TAX, t.READ, G_RARE)
        self._set(f, 1, self.s_key(w, i0), S_QTY, t.READ, G_RARE)
        f["op_extent"][:, 1] = self.scan_len
        return self._batch(f, T, dev, STOCK_LEVEL,
                           torch.full((T,), 2, device=dev))


@functools.lru_cache(maxsize=None)
def _mix(weights: tuple, device: torch.device) -> torch.Tensor:
    """The transaction mix as a float32 tensor on ``device``, made once:
    a wave's draw copies nothing from the host."""
    return torch.tensor(weights, dtype=torch.float32, device=device)
