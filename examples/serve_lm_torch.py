"""Serving with a versioned session store, on the PyTorch + CUDA port.

    PYTHONPATH=src python examples/serve_lm_torch.py             # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The port's counterpart of examples/serve_lm.py.  The server keeps a
*session directory*: one row per session, its columns split like the
paper's District rows:

  group 0 (rarely updated): model id, adapter id, priority class, read by
          every routing/admission decision;
  group 1 (hot):            decode cursor, kv-page head, token count,
          written by every decode batch.

Admission runs as optimistic transactions against this table while
decode batches bump the hot columns.  With one timestamp per row every
admission read conflicts falsely with concurrent cursor bumps; with the
paper's two-group timestamps the conflicts vanish.  The demo measures
both on the port's wave engine, then serves tokens through the port's
prefill/decode path of a smoke-size LM.
"""
import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import torch

from repro_torch import configs
from repro_torch.core import types as t
from repro_torch.core.engine import run as engine_run
from repro_torch.core.types import TxnBatch, store_init
from repro_torch.launch.serve import serve

G_IDENTITY, G_CURSOR = 0, 1


@dataclasses.dataclass(frozen=True)
class SessionStoreWorkload:
    """Admission reads identity columns; decode batches ADD to cursors."""
    n_sessions: int = 4096
    ops_per_txn: int = 8
    n_groups: int = 2
    n_rings: int = 1
    n_txn_types: int = 2          # 0 = admission/routing, 1 = decode bump

    @property
    def n_records(self):
        return self.n_sessions

    @property
    def n_cols(self):
        return 4

    @property
    def slots(self):
        return self.ops_per_txn

    def init_store(self, device=None, mv_depth: int = 0,
                   track_values: bool = False):
        return store_init(self.n_records, self.n_groups, n_rings=self.n_rings,
                          device=device, mv_depth=mv_depth,
                          n_cols=self.n_cols if track_values else 0)

    def gen(self, gen: torch.Generator, wave: int, lanes: int,
            ring_tails: torch.Tensor):
        dev = ring_tails.device
        K = self.ops_per_txn
        # hot sessions: decode batches hammer a small active set
        active = 64
        sess = torch.randint(0, active, (lanes, K), generator=gen,
                             device=dev, dtype=torch.int32)
        is_decode = torch.rand((lanes,), generator=gen, device=dev) < 0.5
        kind = torch.where(is_decode[:, None], t.ADD, t.READ)
        group = torch.where(is_decode[:, None], G_CURSOR, G_IDENTITY)
        batch = TxnBatch(
            op_key=sess,
            op_group=group.expand(lanes, K).to(torch.int32).contiguous(),
            op_col=torch.zeros((lanes, K), dtype=torch.int32, device=dev),
            op_kind=kind.expand(lanes, K).to(torch.int32).contiguous(),
            op_val=torch.ones((lanes, K), dtype=torch.float32, device=dev),
            txn_type=is_decode.to(torch.int32),
            n_ops=torch.full((lanes,), K, dtype=torch.int32, device=dev))
        return batch, ring_tails


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    wl = SessionStoreWorkload()
    print("== session directory: OCC coarse vs fine timestamps ==")
    for gran, name in ((0, "coarse (1 ts/row) "), (1, "fine (2 ts/row)  ")):
        cfg = t.EngineConfig(
            cc=t.CC_OCC, lanes=64, slots=wl.slots, n_records=wl.n_records,
            n_groups=wl.n_groups, n_cols=wl.n_cols,
            n_txn_types=wl.n_txn_types, granularity=gran)
        r = engine_run(cfg, wl, n_waves=150, seed=0, device=args.device)
        print(f"  {name}: {r.throughput:7.2f} txn/us, "
              f"abort {100 * r.abort_rate:5.2f}%  "
              f"(admission commits: {r.commits_by_type[0]})")
    print("  -> identity reads never truly conflict with cursor bumps; "
          "fine timestamps remove the false aborts.\n")

    print("== serving tokens (smoke-size qwen3 backbone) ==")
    res = serve(configs.get_smoke("qwen3-32b"), n_requests=4, prompt_len=24,
                gen=12, device=args.device)
    print(f"  prefill {res.prefill_s * 1e3:.0f}ms, 12 tokens/req in "
          f"{res.decode_s * 1e3:.0f}ms")
    print(f"  request 0 continuation: {res.tokens[0].tolist()}")


if __name__ == "__main__":
    main()
