"""RWKV-6 "Finch": attention-free time-mix with data-dependent decay.
[arXiv:2404.05892]

The port's counterpart of ``repro.models.rwkv6``, with the reference's
casts and orders step for step: per-layer token-shift lerps in the
parameters' dtype, the LoRA-produced per-channel decay ``exp(-exp(w0 +
tanh(x w1) w2))`` in f32, the wkv matrix-state recurrence with the
in-place bonus ``u`` one token at a time in f32, the per-head group norm
and the gate; the squared-ReLU channel mix.  A prefill runs in chunks of
256 tokens (when the prompt is longer and a multiple of it); a decode step
carries ``RWKVState(x_tm, x_cm, wkv)``.  No kernel: the reference's scan
is plain XLA too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import layer_norm
from repro_torch.models.param import Spec
from repro_torch.models.plan import Plan

LORA = 64  # decay LoRA rank (rwkv6 uses 64 for w at 3B scale)


def rwkv_spec(cfg: ModelConfig, plan: Plan):
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.hd
    assert h * hd == d, "rwkv6: heads*head_dim must equal d_model"
    return {
        "ln1": Spec((d,), ("embed",), init="ones"),
        "ln1_b": Spec((d,), ("embed",), init="zeros"),
        "ln2": Spec((d,), ("embed",), init="ones"),
        "ln2_b": Spec((d,), ("embed",), init="zeros"),
        "tm": {  # time mix
            "mu": Spec((5, d), (None, "embed"), init="small"),  # r,k,v,g,w
            "wr": Spec((d, d), ("embed", "q_heads_flat")),
            "wk": Spec((d, d), ("embed", "q_heads_flat")),
            "wv": Spec((d, d), ("embed", "q_heads_flat")),
            "wg": Spec((d, d), ("embed", "q_heads_flat")),
            "w0": Spec((d,), ("embed",), init="small"),
            "w1": Spec((d, LORA), ("embed", None), init="small"),
            "w2": Spec((LORA, d), (None, "embed"), init="small"),
            "u": Spec((h, hd), (None, None), init="small"),
            "ln_w": Spec((d,), ("embed",), init="ones"),   # group-norm scale
            "wo": Spec((d, d), ("q_heads_flat", "embed")),
        },
        "cm": {  # channel mix
            "mu": Spec((2, d), (None, "embed"), init="small"),  # k,r
            "wk": Spec((d, cfg.d_ff), ("embed", "ffn")),
            "wv": Spec((cfg.d_ff, d), ("ffn", "embed")),
            "wr": Spec((d, d), ("embed", None)),
        },
    }


class RWKVState(NamedTuple):
    x_tm: torch.Tensor   # (B, D) last input seen by the time mix
    x_cm: torch.Tensor   # (B, D) last input seen by the channel mix
    wkv: torch.Tensor    # (B, H, hd, hd) f32 matrix state


def init_state(cfg: ModelConfig, batch: int, device=None) -> RWKVState:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return RWKVState(
        x_tm=torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        x_cm=torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        wkv=torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                        device=device))


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]):
    """x (B, S, D) -> the previous-token stream (B, S, D): zeros (or
    ``x_prev``) before the first token."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev[:, None, :], x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, wkv):
    """The recurrence over one chunk: r, k, v, w (B, ck, h, hd) f32, u
    (h, hd) f32, wkv (B, h, hd, hd) f32 -> (wkv, out (B, ck, h, hd)).
    Each token reads the state plus the bonus-weighted ``k v^T``, then the
    state decays by w and takes ``k v^T``."""
    # the chunk's k v^T and bonus terms at once (elementwise: the same
    # values as token by token), then per token one add, one product, one
    # decay and one add
    kv = k[..., :, None] * v[..., None, :]                # (B, ck, h, hd, hd)
    ukv = u[..., :, None] * kv
    outs = []
    for r_t, w_t, kv_t, ukv_t in zip(r[:, :, :, None, :].unbind(1),
                                     w[..., None].unbind(1), kv.unbind(1),
                                     ukv.unbind(1)):
        # "bhk,bhkv->bhv"
        outs.append(torch.matmul(r_t, wkv + ukv_t)[:, :, 0])
        wkv = wkv * w_t + kv_t
    return wkv, torch.stack(outs, dim=1)


def _time_mix_chunk(p, x_c, wkv, x_last, h, hd, u):
    """One chunk x_c (B, ck, D) from the carried (wkv, x_last) -> ((wkv,
    the chunk's last input), y (B, ck, D) in x's dtype), before ``wo``."""
    b, ck, d = x_c.shape
    prev = torch.cat([x_last[:, None], x_c[:, :-1]], dim=1)
    delta = prev - x_c
    mu = p["mu"]

    def lerp(i):
        return x_c + delta * mu[i]

    r = (lerp(0) @ p["wr"]).reshape(b, ck, h, hd).float()
    k = (lerp(1) @ p["wk"]).reshape(b, ck, h, hd).float()
    v = (lerp(2) @ p["wv"]).reshape(b, ck, h, hd).float()
    g = lerp(3) @ p["wg"]
    wl = torch.tanh((lerp(4) @ p["w1"]).float()) @ p["w2"].float()
    w = torch.exp(-torch.exp(p["w0"].float() + wl)).reshape(b, ck, h, hd)
    wkv, y = _wkv_scan(r, k, v, w, u, wkv)
    # per-head group norm: population variance
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + 64e-5)).reshape(b, ck, d)
    y = y * p["ln_w"].float()
    y = y * F.silu(g.float())
    return (wkv, x_c[:, -1]), y.to(x_c.dtype)


def time_mix(p, x: torch.Tensor, cfg: ModelConfig, *,
             x_prev: Optional[torch.Tensor] = None,
             wkv0: Optional[torch.Tensor] = None, chunk: int = 256):
    """x (B, S, D) -> (y (B, S, D), (x_last (B, D), wkv (B, h, hd, hd)))."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    u = p["u"].float()
    wkv = wkv0 if wkv0 is not None else torch.zeros(
        (b, h, hd, hd), dtype=torch.float32, device=x.device)
    x_last = x_prev if x_prev is not None else torch.zeros(
        (b, d), dtype=x.dtype, device=x.device)
    ck = chunk if (s > chunk and s % chunk == 0) else s
    ys = []
    for c0 in range(0, s, ck):
        (wkv, x_last), y_c = _time_mix_chunk(p, x[:, c0:c0 + ck], wkv,
                                             x_last, h, hd, u)
        ys.append(y_c)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    # copies: views would hold the whole normed prompt in the state
    return y @ p["wo"], (x_last.clone(), wkv)


def channel_mix(p, x: torch.Tensor, *, x_prev: Optional[torch.Tensor] = None):
    """x (B, S, D) -> (y (B, S, D), x_last (B, D)): squared ReLU of the
    key, gated by the receptance's sigmoid."""
    delta = _token_shift(x, x_prev) - x
    k = (x + delta * p["mu"][0]) @ p["wk"]
    r = (x + delta * p["mu"][1]) @ p["wr"]
    vk = F.relu(k.float()).square().to(x.dtype)
    return torch.sigmoid(r.float()).to(x.dtype) * (vk @ p["wv"]), \
        x[:, -1].clone()


def rwkv_block(p, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
               state: Optional[RWKVState] = None):
    """One RWKV layer: ln1 -> time mix -> + residual; ln2 -> channel mix ->
    + residual.  The token shifts see the normed activations.  Returns
    (out, the new ``RWKVState``)."""
    xn1 = layer_norm(x, {"w": p["ln1"], "b": p["ln1_b"]}, 1e-5)
    y_tm, (x_last_tm, wkv) = time_mix(
        p["tm"], xn1, cfg, x_prev=None if state is None else state.x_tm,
        wkv0=None if state is None else state.wkv)
    x2 = x + y_tm
    xn2 = layer_norm(x2, {"w": p["ln2"], "b": p["ln2_b"]}, 1e-5)
    y_cm, x_last_cm = channel_mix(
        p["cm"], xn2, x_prev=None if state is None else state.x_cm)
    return x2 + y_cm, RWKVState(x_tm=x_last_tm, x_cm=x_last_cm, wkv=wkv)
