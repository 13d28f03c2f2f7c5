"""Serving entry point of the PyTorch port: batched prefill + greedy decode of
a whole model, with optional FIGCache-KV (counterpart of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --reduced --prompt-len 64 --gen 32 --batch 4 [--figkv]

The standard path uses the exact KV cache (int8 under ``Plan(kv_quant=
True)``); every attention layer's prefill runs the flash-attention kernel
on the card.  Mamba and RWKV layers carry their recurrent states instead
(torch ops, one step a token).  A VLM (Qwen2-VL) is served with a zero vision prefix of
``n_vision_tokens`` before each prompt, Whisper with random frame
embeddings for its encoder, as the JAX package serves them.  ``--figkv`` also exercises
the paper's segment cache on one synthetic layer (``demo_figkv``), but
not for an attention-free model (RWKV).  As in
the JAX package, ``--reduced`` is on by default and the command line
cannot turn it off; ``run(arch, reduced=False)`` serves the full width.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.figkv import (FigKVState, figkv_decode_step, figkv_init,
                               figkv_prefill)
from repro_torch.models import Model, Plan, build_model


class FigKVRun(NamedTuple):
    state: FigKVState
    out: torch.Tensor           # (gen, B, 1, H, D) every step's output
    timings: Dict[str, float]   # prefill_s, decode_s, ms_per_step
    warm: int                   # valid fast-pool slots at the end


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ServeRun(NamedTuple):
    tokens: np.ndarray          # (batch, gen) greedy tokens
    prompt: torch.Tensor        # (batch, prompt_len) the random prompt
    batch: Dict[str, torch.Tensor]  # the prefill's input (prompt, vision
                                    # prefix or audio frames)
    prefill_logits: torch.Tensor  # (batch, 1, Vp) f32, last prompt position
    logits: torch.Tensor        # (batch, 1, Vp) f32, the last decode step
    timings: Dict[str, float]   # prefill_s, decode_s, ms_per_step, tok_s
    model: Model


def serve_batch(model: Model, batch_in: Dict[str, torch.Tensor],
                gen: int) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor,
                                   Dict[str, float]]:
    """Prefill ``batch_in`` into an exact cache, then decode ``gen`` tokens
    greedily -> (tokens (B, gen), prefill logits, last logits, timings).

    A VLM's vision prefix of ``Nv`` embeddings sits before the prompt's
    ``S`` tokens, so decode runs at positions ``S + Nv + i`` and the cache
    holds ``S + Nv + gen + 8`` slots.  (The JAX package sizes it ``S + gen +
    8``: its decode overruns the cache once ``Nv`` exceeds 8, and its
    prefill's write is larger than the cache at Qwen2-VL's 1024 vision
    tokens.)"""
    dev = model.device
    prompt = batch_in["tokens"]
    b, s = prompt.shape
    nv = batch_in["vision_embeds"].shape[1] if "vision_embeds" in batch_in \
        else 0
    caches = model.init_decode(b, s + nv + gen + 8)
    _sync(dev)
    t0 = time.perf_counter()
    caches, logits = model.prefill(batch_in, caches)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    out_tokens = []
    t0 = time.perf_counter()
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(gen):
        out_tokens.append(tok)
        caches, logits = model.decode_step(caches, tok, s + nv + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0
    toks_out = torch.cat(out_tokens, 1).cpu().numpy() if gen else \
        np.zeros((b, 0), np.int64)
    tok_s = b * gen / t_decode if t_decode > 0 else 0.0
    return toks_out, prefill_logits, logits, {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "ms_per_step": t_decode / max(gen, 1) * 1e3, "tok_s": tok_s}


def run(arch: str, *, reduced: bool = True, prompt_len: int = 64,
        gen: int = 32, batch: int = 4, figkv: bool = False, seed: int = 0,
        device=None) -> ServeRun:
    """Build ``arch`` (its reduced config unless ``reduced=False``) with
    random weights from ``seed``, prefill ``batch`` random prompts of
    ``prompt_len`` tokens into an exact KV cache, then decode ``gen``
    tokens greedily (``serve_batch``).  A VLM's prompts follow
    ``n_vision_tokens`` zero embeddings; Whisper's encoder reads
    ``n_audio_frames`` frame embeddings drawn N(0, 1) in bf16, times 0.1.
    Weights, prompts and frames come from one generator on the device, in
    that order.  MoE models run drop-free up to 8192 assignments
    (``Plan(moe_capacity=0)``), as the JAX package serves them."""
    dev = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    model = build_model(cfg, Plan(moe_capacity=0), device=dev)
    rng = torch.Generator(device=dev).manual_seed(seed)
    model.init_params(rng)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=rng, device=dev)
    batch_in = {"tokens": prompt}
    if cfg.family == "vlm":
        batch_in["vision_embeds"] = torch.zeros(
            (batch, cfg.n_vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    if cfg.is_encdec:
        batch_in["audio_embeds"] = torch.randn(
            (batch, cfg.n_audio_frames, cfg.d_model), generator=rng,
            dtype=torch.bfloat16, device=dev) * 0.1
    toks_out, prefill_logits, logits, timings = serve_batch(model, batch_in,
                                                            gen)
    print(f"[serve] {arch}: prefill {prompt_len} toks in "
          f"{timings['prefill_s'] * 1e3:.1f}ms; decoded {gen} x {batch} in "
          f"{timings['decode_s'] * 1e3:.1f}ms ({timings['tok_s']:.1f} tok/s)",
          flush=True)
    if figkv and not cfg.attn_free and cfg.figkv is not None:
        demo_figkv(cfg, torch.Generator(device=dev).manual_seed(seed),
                   prompt_len, gen, batch, device=dev)
    return ServeRun(tokens=toks_out, prompt=prompt, batch=batch_in,
                    prefill_logits=prefill_logits, logits=logits,
                    timings=timings, model=model)


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--figkv", action="store_true")
    args = ap.parse_args()
    run(args.arch, reduced=args.reduced, prompt_len=args.prompt_len,
        gen=args.gen, batch=args.batch, figkv=args.figkv)


if __name__ == "__main__":
    main()
