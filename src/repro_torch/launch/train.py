"""Training entry point of the PyTorch port: the end-to-end loop with the
data pipeline, retries, async checkpoints and restart (counterpart of
``repro.launch.train``), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --shape train_4k --steps 50 --reduced --ckpt "$(mktemp -d)/ckpt"

As in the JAX package, ``--reduced`` is on by default and the command line
cannot turn it off; ``run(arch, shape, reduced=False)`` trains the full
width on the one device (the reference asks for a cluster there).  Every
attention layer's forward runs the flash-attention kernel on the card.
The reference's ``run`` lays its state out on a 1 x 1 test mesh, the
identity layout; the mesh-less step here is its exact equivalent
(``launch.steps.make_train_step(model, hyper, mesh)`` is the sharded one).
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Tuple

import torch

from repro_torch import configs
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, \
    restore_checkpoint
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model
from repro_torch.runtime import HeartbeatMonitor, StepRunner


class TrainRun(NamedTuple):
    losses: List[Tuple[int, float]]   # (step, loss) at the logged steps
    step_s: List[float]               # wall seconds of each step run here
    start: int                        # first step run (after a restore)


def run(arch: str, shape_name: str, *, steps: int = 50, reduced: bool = True,
        ckpt_dir: str | None = None, ckpt_every: int = 20,
        grad_compress: bool = False, log_every: int = 5,
        batch_override: int | None = None, seq_override: int | None = None,
        device=None) -> TrainRun:
    """Train ``arch`` on ``shape_name``'s batches for ``steps`` steps (from
    the latest committed checkpoint under ``ckpt_dir`` and its data
    cursor, if any), checkpointing every ``ckpt_every`` steps.  Each
    step's wall time is taken after the device has finished it."""
    dev = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    shape = configs.SHAPES[shape_name]
    if batch_override or seq_override:
        shape = configs.ShapeConfig(shape.name, shape.kind,
                                    seq_override or shape.seq_len,
                                    batch_override or shape.global_batch)
    hyper = steps_lib.Hyper(peak_lr=1e-3, warmup=10, total_steps=steps,
                            grad_compress=grad_compress)
    plan = steps_lib.make_plan(cfg, shape,
                               overrides={"microbatches": 1, "remat": "full"})
    model = build_model(cfg, plan, device=dev)
    state = steps_lib.init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), hyper)
    step_fn = steps_lib.make_train_step(model, hyper)
    start = 0
    pipe = DataPipeline(cfg, shape, seed=0)
    if ckpt_dir and (ls := latest_step(ckpt_dir)) is not None:
        state, extra = restore_checkpoint(ckpt_dir, ls, state)
        start = ls + 1
        pipe.cursor.step = extra.get("data_step", start)
        print(f"[train] restored step {ls} from {ckpt_dir}")
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    runner = StepRunner(step_fn, checkpointer=ckpt,
                        monitor=HeartbeatMonitor(["w0"]),
                        ckpt_every=ckpt_every)
    pipe.start_prefetch()
    losses, step_s = [], []
    try:
        for s in range(start, steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.get().items()}
            t0 = time.perf_counter()
            state, metrics = runner.run(
                s, state, batch, extra={"data_step": pipe.next_step})
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t0)
            if s % log_every == 0 or s == steps - 1:
                loss = float(metrics["loss"])
                losses.append((s, loss))
                print(f"[train] step {s:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{step_s[-1] * 1e3:.1f} ms")
    finally:
        pipe.stop()
        if ckpt:
            ckpt.wait()
    return TrainRun(losses, step_s, start)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args()
    t0 = time.time()
    out = run(args.arch, args.shape, steps=args.steps, reduced=args.reduced,
              ckpt_dir=args.ckpt, grad_compress=args.grad_compress,
              batch_override=args.batch, seq_override=args.seq)
    if out.losses:
        print(f"[train] done in {time.time() - t0:.1f}s; loss "
              f"{out.losses[0][1]:.3f} -> {out.losses[-1][1]:.3f}")


if __name__ == "__main__":
    main()
