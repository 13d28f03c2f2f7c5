"""Shared NN building blocks: RMS and layer norms, RoPE and Qwen2-VL's
M-RoPE, Whisper's sinusoids, SwiGLU and GELU FFNs, embeddings, LM head,
cross-entropy (whole and chunked), weight-only int8.

The port's counterpart of ``repro.models.layers``, with the reference's
casts step for step: bf16 storage and matmuls, f32 norm statistics, RoPE
angles and activations.  Transcendentals take the reference CPU build's
bits: sines and cosines glibc's (``sincosf``), GELU's tanh XLA's
(``xla_math.tanh_f32``).  Every function takes the parameters it reads
(``ParamTree`` entries or plain tensors).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.workload.xla_math import tanh_f32
from repro_torch.models.param import Spec
from repro_torch.models.sincosf import sincos_f32
from repro_torch.spmd import (contiguous_stride, is_dtensor, pair_halves,
                              redistribute_to, to_local)

NEG = -1e30


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp``'s matmul: an
    f32 activation against a bf16 weight (Whisper's encoder on f32 frame
    embeddings) reads the weight in f32.  Of one dtype, plain ``x @ w``."""
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def rms_norm_spec(d: int) -> Spec:
    return Spec((d,), ("embed",), init="ones")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, round to x's dtype, then times the weight."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm_spec(d: int):
    return {"w": Spec((d,), ("embed",), init="ones"),
            "b": Spec((d,), ("embed",), init="zeros")}


def layer_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """Centre and normalise in f32, round to x's dtype, times the weight,
    plus the bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["w"] + p["b"]


def _pow_f32(base: float, exps: torch.Tensor) -> torch.Tensor:
    """``base ** exps`` for f32 exponents: taken in f64 and rounded, i.e.
    the correctly rounded f32 power, which is what XLA's f32 power gives on
    every exponent used here (torch's f32 ``pow`` is one ulp off on a few
    of Qwen2-7B's 64 frequencies)."""
    return torch.pow(float(base), exps.double()).float()


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, dim//2), f32 products of the
    positions and the frequencies ``theta ** (-i / half)`` (the exponents
    in f32, ``half = dim // 2``)."""
    half = dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    return positions[..., None].float() * _pow_f32(theta, exps)


def mrope_angles(positions3: torch.Tensor, dim: int, theta: float,
                 sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: positions3 (3, B, S), the (t, h, w)
    streams -> angles (B, S, dim//2).  ``sections`` partitions the
    ``dim//2`` frequency slots among the streams in order: slot j takes
    its angle from the stream whose section holds it."""
    assert sum(sections) == dim // 2, (sections, dim)
    angles = rope_angles(positions3, dim, theta)        # (3, B, S, dim/2)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(angles[i, :, :, start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def sinusoid_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings (n, d) f32: ``sin`` then
    ``cos`` of ``pos * 10000 ** (-i / (d/2 - 1))``, glibc's ``sinf`` /
    ``cosf`` as the reference's CPU build calls them."""
    half = d // 2
    exps = -torch.arange(half, dtype=torch.float32, device=device) / \
        torch.full((), float(half - 1), device=device)
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * \
        _pow_f32(10000.0, exps)
    sin, cos = sincos_f32(ang)
    return torch.cat([sin, cos], dim=-1)


def rope_tables(angles: torch.Tensor):
    """angles (B, S, D/2) -> (sin, cos), each (B, S, 1, D/2) f32: the C
    library's ``sinf`` / ``cosf``, which the reference's CPU build calls
    (``sincosf``).  Taken once a forward and shared by every layer."""
    sin, cos = sincos_f32(angles)
    return sin[:, :, None, :], cos[:, :, None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x (B, S, H, D), rope ``rope_tables``' (sin, cos) -> rotated x
    (rotate-half convention), computed in f32 and rounded to x's dtype."""
    sin, cos = rope
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_spec(d: int, f: int):
    return {"wi": Spec((d, 2 * f), ("embed", "ffn")),
            "wo": Spec((f, d), ("ffn", "embed"))}


def _split_columns(wi, x):
    """The mesh dim that splits the columns of a ``DTensor`` weight wi
    (d, 2f) and does not split the ``DTensor`` x (..., d), else None."""
    if not (is_dtensor(wi) and is_dtensor(x)):
        return None
    from torch.distributed.tensor import Shard
    for i, (pl, n) in enumerate(zip(wi.placements, wi.device_mesh.shape)):
        if getattr(pl, "dim", None) == wi.dim() - 1 and n > 1:
            return None if isinstance(x.placements[i], Shard) else i
    return None


def _swiglu_split(p, x, tp: int):
    """``swiglu`` where mesh dim ``tp`` splits wi's [gate | up] columns as
    one: rank r holds gate columns or up columns, so its product has no
    pair.  ``spmd.pair_halves`` pairs them with one all-to-all, of the
    local product or of the local weight shard, whichever is smaller
    (the rank's tokens against the weight's rows), and h keeps its ffn
    slice for the down projection: no rank gathers the weight, nor the
    product.  The data axes are gathered where FSDP splits the weight
    over them; wi's gradient is a partial sum over the data axes that
    split x, x's over ``tp``.  A pending sum in x is reduced first, as
    the product would."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    wi = p["wi"]
    mesh = wi.device_mesh
    x = redistribute_to(x, tuple(Replicate() if isinstance(pl, Partial)
                                 else pl for pl in x.placements))
    xl = to_local(x, tuple(Partial() if i == tp else pl
                           for i, pl in enumerate(x.placements)))
    w = redistribute_to(wi, tuple(pl if i == tp else Replicate()
                                  for i, pl in enumerate(wi.placements)))
    wl = to_local(w, tuple(pl if i == tp else (
        Partial() if isinstance(q, Shard) else Replicate())
        for i, (pl, q) in enumerate(zip(w.placements, x.placements))))
    if xl.numel() // xl.shape[-1] > wl.shape[0]:
        g, u = (xl @ pair_halves(wl, mesh, tp)).chunk(2, dim=-1)
    else:
        g, u = pair_halves(xl @ wl, mesh, tp).chunk(2, dim=-1)
    h = F.silu(g.float()).to(x.dtype) * u
    shape = x.shape[:-1] + (wi.shape[-1] // 2,)
    h = DTensor.from_local(h, mesh, tuple(
        Shard(h.dim() - 1) if i == tp else pl
        for i, pl in enumerate(x.placements)), run_check=False,
        shape=shape, stride=contiguous_stride(shape))
    return h @ p["wo"]


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """silu in f32, cast to x's dtype, gate, down projection.  On a mesh
    that splits wi's columns, ``_swiglu_split``."""
    tp = _split_columns(p["wi"], x)
    if tp is not None:
        return _swiglu_split(p, x, tp)
    g, u = (x @ p["wi"]).chunk(2, dim=-1)
    return (F.silu(g.float()).to(x.dtype) * u) @ p["wo"]


def gelu_mlp_spec(d: int, f: int):
    return {"wi": Spec((d, f), ("embed", "ffn")),
            "bi": Spec((f,), ("ffn",), init="zeros"),
            "wo": Spec((f, d), ("ffn", "embed")),
            "bo": Spec((d,), ("embed",), init="zeros")}


_SQRT_2_OVER_PI = 0.7978845834732056       # np.sqrt(2 / np.pi) in f32


_GELU_CONSTS = tuple(torch.tensor(c, dtype=torch.float32)
                     for c in (_SQRT_2_OVER_PI, 0.044715, 0.5, 1.0))


class _Tanh(torch.autograd.Function):
    """``tanh_f32`` with JAX's derivative of ``tanh``, ``(g + g y)(1 - y)``
    on the forward's y.  ``tanh_f32`` reads its input's bits through an
    integer view, which autograd cannot differentiate: without this the
    tanh term of GELU's gradient was lost."""

    @staticmethod
    def forward(ctx, x):
        y = tanh_f32(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return (g + g * y) * (1 - y)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` of an f32 tensor, one rounded
    f32 operation at a time in the reference's order: ``x * (x * x)``,
    ``0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))``, times x; the
    tanh is XLA's (``tanh_f32``).  Bitwise the eager reference; torch's
    ``gelu(approximate="tanh")`` differs on a third of inputs.  The
    constants are f32 scalars on the host: only multiplied and added, they
    give the same bits as device tensors and cost no copy.  The tanh's
    gradient is JAX's (``_Tanh``)."""
    c_sqrt, c_cube, c_half, c_one = _GELU_CONSTS
    inner = c_sqrt * (x + c_cube * (x * (x * x)))
    return x * (c_half * (c_one + _Tanh.apply(inner)))


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """Up projection plus bias, GELU (tanh form) in f32, cast to x's dtype,
    down projection plus bias."""
    h = gelu_tanh((matmul(x, p["wi"]) + p["bi"]).float())
    return matmul(h.to(x.dtype), p["wo"]) + p["bo"]


def embed_spec(vocab_padded: int, d: int, tied: bool = True) -> Spec:
    if tied:
        return Spec((vocab_padded, d), ("vocab", "embed"), init="embed")
    return Spec((vocab_padded, d), ("vocab_in", "embed_tp"), init="embed")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(x: torch.Tensor, table_or_head: torch.Tensor,
              vocab_logical: int, transpose: bool, plan=None) -> torch.Tensor:
    """Project to the (padded) vocab in x's dtype, then f32; padded slots
    are masked to -1e30.  With a ``plan`` the logits keep the vocab split
    over the model axis (``Plan.hint``)."""
    w = table_or_head.t() if transpose else table_or_head   # (d, Vp)
    logits = (x @ w).float()
    if plan is not None:
        logits = plan.hint(logits, "dp", None, "tp")  # keep vocab sharded
    vp = logits.shape[-1]
    if vp > vocab_logical:
        pad = torch.arange(vp, device=logits.device) >= vocab_logical
        logits = logits.masked_fill(pad, NEG)
    return logits


class _VocabParallelNLL(torch.autograd.Function):
    """-log p(target) per position of local f32 logits (..., V/n), this
    rank's ``v0``-based slice of a vocab split over ``group``'s n ranks:
    the max, the sum of exponentials and the target's logit (from the
    rank whose slice holds it, zeros elsewhere) each reduced over the
    group, the last two in one all-reduce.  The backward is local,
    ``g * (softmax - onehot)`` on the rank's own slice: no collective."""

    @staticmethod
    def forward(ctx, logits, tgt, v0: int, group):
        import torch.distributed._functional_collectives as funcol
        m = funcol.wait_tensor(funcol.all_reduce(
            logits.detach().amax(dim=-1), "max", group))
        local = tgt - v0
        zg = torch.stack([(logits - m[..., None]).exp().sum(dim=-1),
                          torch.where(_onehot(logits, local), logits,
                                      0.0).sum(dim=-1)])
        z, gold = funcol.wait_tensor(funcol.all_reduce(zg, "sum", group))
        ctx.save_for_backward(logits, m, z, local)
        return z.log() + m - gold

    @staticmethod
    def backward(ctx, g):
        logits, m, z, local = ctx.saved_tensors
        p = (logits - m[..., None]).exp() / z[..., None]
        return (p - _onehot(logits, local).to(p.dtype)) * g[..., None], \
            None, None, None


def _onehot(logits, local):
    """Where the last dim of ``logits`` is the slice's index ``local``
    (no entry where the target lies outside the slice)."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return ids == local[..., None]


def _vocab_parallel_nll(logits, tgt):
    """-log p(target) per position of a ``DTensor``'s f32 logits (..., V)
    whose vocab is split over one mesh dim (``_VocabParallelNLL`` on the
    local shards) -> a ``DTensor`` (...) laid out as the logits' other
    dims."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, last = logits.device_mesh, logits.dim() - 1
    pls = tuple(logits.placements)
    vd = next(i for i, pl in enumerate(pls) if getattr(pl, "dim", None)
              in (-1, last))
    rest = tuple(Replicate() if i == vd else pl for i, pl in enumerate(pls))
    if not is_dtensor(tgt):
        tgt = DTensor.from_local(tgt, mesh, tuple(Replicate() for _ in pls),
                                 run_check=False)
    tgt = redistribute_to(tgt, rest).to_local()
    v0 = mesh.get_local_rank(vd) * -(-logits.shape[-1] // mesh.shape[vd])
    nll = _VocabParallelNLL.apply(to_local(logits), tgt, v0,
                                  mesh.get_group(vd))
    shape = logits.shape[:-1]
    return DTensor.from_local(nll, mesh, rest, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor,
             ignore_id: int = -1):
    """(sum of -log p(target) over the non-ignored targets, their count):
    logits f32 (..., V), targets (...).  On a mesh that splits the vocab
    the logits stay split, forward and backward
    (``_vocab_parallel_nll``)."""
    valid = targets != ignore_id
    tgt = torch.clamp(targets, min=0).long()
    if is_dtensor(logits) and any(
            getattr(p, "dim", None) in (-1, logits.dim() - 1)
            and n > 1 for p, n in zip(logits.placements,
                                      logits.device_mesh.shape)):
        return (_vocab_parallel_nll(logits, tgt) * valid).sum(), valid.sum()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean CE over the targets that are not ``ignore_id``; logits f32
    (B, S, V)."""
    nll, cnt = _nll_sum(logits, targets, ignore_id)
    return nll / torch.clamp(cnt, min=1)


def _ce_chunk(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
              vocab_logical: int, transpose: bool, plan=None):
    return _nll_sum(lm_logits(x, head, vocab_logical, transpose, plan),
                    targets)


def chunked_ce(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
               vocab_logical: int, *, transpose: bool,
               chunk: int = 1024, plan=None) -> torch.Tensor:
    """Cross-entropy of the LM head over x (B, S, d) without holding the
    (B, S, V) logits: chunks of ``chunk`` positions along S, each chunk's
    logits recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint(nothing_saveable)`` scan body), so one
    chunk's logits are live at a time in the forward and in the backward.
    The chunks' sums are added in order, as the reference's scan.  A
    sequence of one chunk or less, or not a multiple of it, takes the
    whole logits."""
    b, s, _ = x.shape
    if s % chunk or s <= chunk:
        return cross_entropy(lm_logits(x, head, vocab_logical, transpose,
                                       plan), targets)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, s, chunk):
        n, c = checkpoint(_ce_chunk, x[:, c0:c0 + chunk], head,
                          targets[:, c0:c0 + chunk], vocab_logical, transpose,
                          plan, use_reentrant=False)
        nll, cnt = nll + n, cnt + c
    return nll / torch.clamp(cnt, min=1)


def quantize_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 of a (K, N) weight: (codes (K, N)
    int8, scales (1, N) f32), ``round(w / max(s, 1e-8))`` clipped to +-127
    with ``s = max_k |w| / 127``.  The divisors are tensors on w's device
    (see ``attention._quant_kv``)."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True) / torch.full(
        (), 127.0, device=w.device)
    q = torch.round(wf / torch.clamp(scale, min=1e-8))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def matmul_int8(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(q): the codes cast to x's dtype, the product times the
    scales cast to x's dtype."""
    return (x @ q.to(x.dtype)) * scale.to(x.dtype)
