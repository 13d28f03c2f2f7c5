"""End-to-end training example on the PyTorch port: train a reduced config
for a few hundred steps with checkpoint/restart and async checkpointing
(the port's counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \
        [--arch qwen1.5-0.5b] [--ckpt DIR] [--device cpu]

Uses the same ``repro_torch.launch.train`` machinery as the port's entry
point.  ``--device`` defaults to the CUDA device, which must exist;
without ``--ckpt`` the checkpoints go to a fresh temporary directory.
"""
import argparse
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch.train import run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    out = run(args.arch, "train_4k", steps=args.steps, reduced=True,
              ckpt_dir=ckpt, ckpt_every=50, batch_override=args.batch,
              seq_override=args.seq, device=dev)
    first, last = out.losses[0][1], out.losses[-1][1]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
