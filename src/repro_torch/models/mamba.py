"""Mamba selective-SSM block (Jamba's sequence mixer).  [arXiv:2312.00752]

The port's counterpart of ``repro.models.mamba``, with the reference's
casts and orders step for step: the projections in the parameters' dtype,
the depthwise causal conv as ``d_conv`` products summed in that dtype, the
discretisation and the recurrence in f32.  A prefill runs in chunks of 256
tokens (when the prompt is longer and a multiple of it): each chunk
computes its own ``dt`` / B / C / ``dA`` / ``dBx`` and runs the recurrence
``h = h * dA + dBx`` one token at a time (a multiply, then an add, each
rounded), contracting with C at once.  A decode step (S == 1) carries
``MambaState(conv, ssm)``.  No kernel: the reference's scan is plain XLA
too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.param import Spec
from repro_torch.models.plan import Plan


def _dims(cfg: ModelConfig):
    mm = cfg.mamba
    d_in = mm.expand * cfg.d_model
    dtr = mm.dt_rank or -(-cfg.d_model // 16)
    return d_in, dtr, mm.d_state, mm.d_conv


def mamba_spec(cfg: ModelConfig, plan: Plan):
    d = cfg.d_model
    d_in, dtr, n, dc = _dims(cfg)
    return {
        "in_proj": Spec((d, 2 * d_in), ("embed", "ffn")),
        "conv_w": Spec((dc, d_in), (None, "ffn")),
        "conv_b": Spec((d_in,), ("ffn",), init="zeros"),
        "x_proj": Spec((d_in, dtr + 2 * n), ("ffn", None)),
        "dt_proj": Spec((dtr, d_in), (None, "ffn")),
        "dt_bias": Spec((d_in,), ("ffn",), init="zeros"),
        "A_log": Spec((d_in, n), ("ffn", None), init="small"),
        "D": Spec((d_in,), ("ffn",), init="ones"),
        "out_proj": Spec((d_in, d), ("ffn", "embed")),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv - 1, d_in) the last inputs of the conv
    ssm: torch.Tensor    # (B, d_in, d_state) f32


def init_state(cfg: ModelConfig, batch: int, device=None) -> MambaState:
    d_in, _, n, dc = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, dc - 1, d_in), dtype=torch.bfloat16,
                         device=device),
        ssm=torch.zeros((batch, d_in, n), dtype=torch.float32,
                        device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]):
    """Depthwise causal conv1d, x (B, S, d_in), w (d_conv, d_in): the
    ``d_conv`` shifted products added in x's dtype from the oldest tap
    (Python's ``sum``, as the reference), then the bias.  A decode puts
    ``state`` (the last ``d_conv - 1`` inputs) before x instead of zeros;
    returns (out, the new state)."""
    dc = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, dc - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(dc)) + b
    # a copy: a view would hold the whole padded prompt
    new_state = xp[:, xp.shape[1] - (dc - 1):, :].clone() if dc > 1 \
        else xp[:, :0]
    return out, new_state


def _scan_chunk(p, h: torch.Tensor, xi_c: torch.Tensor, A: torch.Tensor,
                dtr: int, n: int):
    """One chunk xi_c (B, ck, d_in) from the carried h (B, d_in, n) f32 ->
    (h, y_c (B, ck, d_in) f32)."""
    dbc = xi_c @ p["x_proj"]
    dt_r, bc, cc = dbc.split([dtr, n, n], dim=-1)
    dt = F.softplus((dt_r @ p["dt_proj"] + p["dt_bias"]).float())
    dA = torch.exp(dt[..., None] * A)                     # (B, ck, d_in, n)
    dBx = (dt * xi_c.float())[..., None] * bc.float()[:, :, None, :]
    return _recurrence(h, dA, dBx, cc.float())


def _recurrence(h: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor,
                c: torch.Tensor):
    """The selective scan over one chunk, a token at a time: h (B, d_in, n),
    dA, dBx (B, ck, d_in, n), c (B, ck, n), all f32 -> (h, y (B, ck,
    d_in)), each token's ``h = h * dA + dBx`` contracted with its C."""
    ys = []
    for dA_t, dBx_t, c_t in zip(dA.unbind(1), dBx.unbind(1),
                                c[..., None].unbind(1)):
        h = h * dA_t + dBx_t
        ys.append(torch.bmm(h, c_t)[..., 0])             # "bdn,bn->bd"
    return h, torch.stack(ys, dim=1)


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
                  state: Optional[MambaState] = None, decode: bool = False,
                  chunk: int = 256):
    """x (B, S, D) -> (out (B, S, D), new ``MambaState``).  A decode step
    is S == 1 with ``state`` carried; a prefill with ``state`` (zeros from
    ``init_state``) gives the same outputs as without it."""
    d_in, dtr, n, dc = _dims(cfg)
    b, s, _ = x.shape
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                None if state is None else state.conv)
    xi = F.silu(xi.float()).to(x.dtype)
    A = -torch.exp(p["A_log"].float())                    # (d_in, n)
    h = state.ssm if state is not None else torch.zeros(
        (b, d_in, n), dtype=torch.float32, device=x.device)
    ck = chunk if (s > chunk and s % chunk == 0) else s
    ys = []
    for c0 in range(0, s, ck):
        h, y_c = _scan_chunk(p, h, xi[:, c0:c0 + ck], A, dtr, n)
        ys.append(y_c)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + xi.float() * p["D"].float()
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    return out, MambaState(conv=new_conv, ssm=h)
