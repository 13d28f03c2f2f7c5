"""Serving driver of the PyTorch port: the FIGCache-KV segment cache on one
synthetic attention layer (counterpart of ``repro.launch.serve.demo_figkv``).

The LM serving loop of the JAX package (``run`` / ``main``: prefill and
decode of a whole model) needs the model stack, which is not ported yet
(ROADMAP.md, Queue 1 item 14); it comes with it.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.figkv import (FigKVState, figkv_decode_step, figkv_init,
                               figkv_prefill)


class FigKVRun(NamedTuple):
    state: FigKVState
    out: torch.Tensor           # (gen, B, 1, H, D) every step's output
    timings: Dict[str, float]   # prefill_s, decode_s, ms_per_step
    warm: int                   # valid fast-pool slots at the end


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def demo_figkv(cfg: ModelConfig, generator: torch.Generator,
               prompt_len: int, gen: int, batch: int, device=None
               ) -> FigKVRun:
    """Exercise the FIGCache-KV segment cache on one synthetic layer at
    ``cfg``'s attention width: prefill ``prompt_len`` random tokens of KV,
    then ``gen`` decode steps with random bf16 q / k / v, all drawn from
    ``generator`` (which must live on ``device``).  Same knobs as the JAX
    package: ``n_sel=8``, ``recent=2*seg_tokens``,
    ``s_max = prompt_len + gen + seg_tokens``."""
    dev = resolve_device(device)
    fig = cfg.figkv
    hkv, hq, d = cfg.n_kv_heads, cfg.n_heads, cfg.hd
    dtype = torch.bfloat16

    def draw(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    state = figkv_init(batch, prompt_len + gen + fig.seg_tokens, hkv, d, fig,
                       dtype=dtype, device=dev)
    k0, v0 = draw(batch, prompt_len, hkv, d), draw(batch, prompt_len, hkv, d)
    _sync(dev)
    t0 = time.perf_counter()
    state = figkv_prefill(state, k0, v0)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    del k0, v0
    outs = []
    t0 = time.perf_counter()
    for _ in range(gen):
        q = draw(batch, 1, hq, d)
        kn, vn = draw(batch, 1, hkv, d), draw(batch, 1, hkv, d)
        state, out = figkv_decode_step(state, q, kn, vn, fig, n_sel=8,
                                       recent=fig.seg_tokens * 2)
        outs.append(out)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    warm = int(state.fts.valid.sum())
    print(f"[serve]   figkv: {gen} steps in {t_decode * 1e3:.1f}ms; fast pool "
          f"{warm}/{state.fts.valid.numel()} slots warm", flush=True)
    return FigKVRun(state=state, out=torch.stack(outs),
                    timings={"prefill_s": t_prefill, "decode_s": t_decode,
                             "ms_per_step": t_decode / max(gen, 1) * 1e3},
                    warm=warm)
