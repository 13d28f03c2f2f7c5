"""Serving example on the PyTorch port: batched prefill + decode, with the
FIGCache-KV segment cache demo (hot KV segments relocated into the fast
pool); the port's counterpart of ``examples/serve_decode.py``.

    PYTHONPATH=src python examples/torch_serve_decode.py [--arch qwen2-7b]
        [--device cpu]

``--device`` defaults to the CUDA device, which must exist.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.serve import run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    run(args.arch, reduced=True, prompt_len=args.prompt_len, gen=args.gen,
        batch=args.batch, figkv=True, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
