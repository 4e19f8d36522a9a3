"""Fault-tolerant training driver (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --smoke --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --smoke --steps 50 --ckpt-dir /path/to/ckpt

- supervisor loop: a ``SimulatedFailure`` (``--fail-at``) drops the state
  in memory and resumes from the last durable checkpoint
  (``run_supervised``, the API the fault-tolerance tests drive);
- checkpoints: interval, async, atomic (``repro_torch.checkpoint``), a
  config fingerprint refusing another architecture;
- data: the stateless ``make_batch(step)``, so a resumed run replays the
  same stream;
- preemption: SIGTERM flushes the pending checkpoint before exit.

``--device cuda`` (the default) runs the kernels (``flash_attention``,
``rglru`` and ``rwkv6``, forward and backward) and raises without CUDA;
``--device cpu`` runs their plain versions.  One card or the CPU:
``--data`` / ``--model`` above 1 raise (ROADMAP A.12.3c).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import tempfile
import time

import torch

from repro_torch.models.common import tree_map


@dataclasses.dataclass
class TrainRun:
    """Everything the supervisor needs to (re)build step state."""
    cfg: object
    optimizer: object
    shape: object
    ckpt: object                    # CheckpointManager
    injector: object = None
    log_every: int = 10
    device: object = "cuda"

    def build(self):
        from repro_torch.models import steps
        return steps.build_train_step(self.cfg, self.optimizer)

    def fresh_state(self, seed: int = 0):
        from repro_torch.models import model as model_mod
        params = model_mod.init_params(self.cfg, seed, self.device)
        return params, self.optimizer.init(params)


def _restore(run: TrainRun, like):
    """(params, opt_state, step) from the newest checkpoint, or None.
    ``like`` holds the shapes and dtypes only (meta tensors), so the
    restore does not hold a second copy of the state."""
    restored, manifest = run.ckpt.restore_latest(like, device=run.device)
    if restored is None:
        return None
    return restored["params"], restored["opt"], manifest["step"]


def run_supervised(run: TrainRun, total_steps: int, *, seed: int = 0,
                   max_restarts: int = 20, save_final: bool = True):
    """Train to ``total_steps``, surviving failures; the state is saved at
    the end too unless ``save_final`` is False (a caller whose state is
    larger than its disk).  Returns (params, opt_state, [(step, loss)],
    restarts)."""
    from repro_torch.data import make_batch
    from repro_torch.ft.failures import SimulatedFailure

    step_fn = run.build()
    params, opt_state = run.fresh_state(seed)
    like = tree_map(lambda t: t.to("meta"),
                    {"params": params, "opt": opt_state})
    start = 0
    got = _restore(run, like)
    if got is not None:
        params, opt_state, start = got
        print(f"[train] resumed from step {start}")

    restarts = 0
    step = start
    losses = []
    while step < total_steps:
        try:
            batch = make_batch(run.cfg, run.shape, step, device=run.device)
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            if run.injector is not None:
                run.injector.maybe_fail(step)
            step += 1
            run.ckpt.maybe_save(step, {"params": params, "opt": opt_state})
            if step % run.log_every == 0 or step == total_steps:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f}")
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            print(f"[train] {e} -> restart {restarts}")
            # drop the state and restore the last durable checkpoint
            run.ckpt.wait()
            params = opt_state = None
            got = _restore(run, like)
            if got is not None:
                params, opt_state, step = got
            else:
                params, opt_state = run.fresh_state(seed)
                step = 0
    if save_final:
        run.ckpt.maybe_save(step, {"params": params, "opt": opt_state},
                            force=True)
    run.ckpt.wait()
    return params, opt_state, losses, restarts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small smoke configuration")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain PyTorch versions of the "
                         "kernels")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel width (1: one card)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel width (1: one card)")
    args = ap.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: training on more "
            f"than one card is not ported to repro_torch yet (ROADMAP "
            f"A.12.3c)")

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.types import resolve_device
    from repro_torch.ft import FailureInjector
    from repro_torch.launch.serve import card_line
    from repro_torch.optim import AdamW

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    dev = resolve_device(args.device)
    seq = args.seq + (cfg.n_patches or 0)
    shape = ShapeSpec("cli", "train", seq, args.batch)
    opt = AdamW.from_config(cfg, peak_lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 1))
    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_every,
                             fingerprint=f"{cfg.name}-smoke={args.smoke}")
    run = TrainRun(cfg=cfg, optimizer=opt, shape=shape, ckpt=ckpt,
                   injector=FailureInjector(at_steps=tuple(args.fail_at)),
                   device=dev)

    def flush(sig, frame):
        print("[train] SIGTERM: flushing checkpoint")
        ckpt.wait()
        sys.exit(0)

    signal.signal(signal.SIGTERM, flush)

    print(f"[train] {cfg.name} on {card_line(dev)}")
    t0 = time.time()
    _, _, losses, restarts = run_supervised(run, args.steps, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"[train] done: {args.steps} steps in {dt:.1f}s, "
          f"{restarts} restarts, final loss {losses[-1][1]:.4f}")
    return losses, restarts


if __name__ == "__main__":
    main()
