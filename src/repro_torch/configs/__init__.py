"""Configuration system: model architecture + input-shape registry.

The port's own copy of ``repro.configs`` (plain data, no tensor code): the
same dataclasses, the same ten architecture modules and the same lookups,
so the port never imports the JAX package.

Every assigned architecture lives in its own module (``configs/<id>.py``)
exposing ``CONFIG`` (the exact published shape) and ``REDUCED`` (a tiny
same-family config for CPU smoke tests).  ``get(name)`` / ``get_reduced(name)``
look them up; ``list_archs()`` enumerates the pool.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Sub-configs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert ffn hidden size
    n_shared: int = 0              # shared (always-on) experts
    layer_period: int = 1          # MoE on layers where (i % period == offset)
    layer_offset: int = 0
    first_dense: int = 0           # leading dense-FFN layers (ds-v2-lite: 1)
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class FIGKVConfig:
    """The paper's technique (FIGCache) applied to the KV cache / embeddings.

    Terminology maps 1:1 onto the paper: a *segment* is the relocation unit
    (paper: 16 cache blocks = 1/8 row; here: ``seg_tokens`` tokens of KV), the
    *fast pool* is the fast-subarray region (``fast_rows`` rows of
    ``segs_per_row`` segment slots), and the tag store carries
    {tag, valid, dirty, benefit} exactly like the FTS.
    """
    seg_tokens: int = 16
    fast_rows: int = 64
    segs_per_row: int = 8
    benefit_bits: int = 5
    policy: str = "row_benefit"    # row_benefit|segment_benefit|lru|random
    insert_threshold: int = 1


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|vlm|audio|hybrid|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0        # 0 -> full attention
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    # hybrid (jamba): attention on layers where (i % period == offset); others Mamba
    attn_layer_period: int = 0
    attn_layer_offset: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    n_audio_frames: int = 1500
    # vlm (qwen2-vl): M-RoPE + patch-embedding stub
    m_rope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_vision_tokens: int = 0
    # ssm (rwkv6)
    rwkv: bool = False
    dtype: str = "bfloat16"
    figkv: Optional[FIGKVConfig] = None

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.rwkv

    def attn_layers(self):
        """Indices of attention layers (hybrid archs); all layers otherwise."""
        if self.rwkv:
            return []
        if self.attn_layer_period:
            return [i for i in range(self.n_layers)
                    if i % self.attn_layer_period == self.attn_layer_offset]
        return list(range(self.n_layers))

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context without O(S^2)/full-KV attention?

        SSM: recurrent state only.  Hybrid: few attention layers (we run them
        with sequence-sharded distributed decode + FIGCache-KV).  SWA: KV
        bounded by the window.
        """
        if self.rwkv:
            return True
        if self.attn_layer_period:       # hybrid: sparse-in-depth attention
            return True
        if self.sliding_window:
            return True
        return False

    def n_params(self) -> int:
        """Analytical parameter count (logical, unpadded)."""
        d, hd = self.d_model, self.hd
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        total = emb + out + d  # final norm

        def attn_params():
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * nq * qk                              # q proj
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)   # kv down + shared rope
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d                   # o
                return p
            p = d * (nq + 2 * nkv) * hd + nq * hd * d
            if self.qkv_bias:
                p += (nq + 2 * nkv) * hd
            return p

        def dense_ffn():
            return 3 * d * self.d_ff                          # swiglu

        def moe_ffn(m: MoEConfig):
            per = 3 * d * m.d_expert
            return (m.n_experts + m.n_shared) * per + d * m.n_experts  # + router

        def mamba_params(mm: MambaConfig):
            d_in = mm.expand * d
            dtr = mm.dt_rank or -(-d // 16)
            p = d * 2 * d_in                 # in_proj (x, z)
            p += d_in * mm.d_conv            # conv
            p += d_in * (dtr + 2 * mm.d_state)  # x -> (dt, B, C)
            p += dtr * d_in                  # dt proj
            p += d_in * mm.d_state + d_in    # A, D
            p += d_in * d                    # out
            return p

        def rwkv_params():
            # time-mix (r,k,v,g,w projections + output) + channel-mix
            p = 4 * d * d + d * d            # r,k,v,g + o
            p += 2 * d * 64 + 64 * d         # data-dependent decay lora (w1,w2)
            p += 2 * (d * self.d_ff // 2) + d * self.d_ff  # channel mix (k, r, v)
            return p

        attn_set = set(self.attn_layers())
        for i in range(self.n_layers):
            total += 2 * d  # norms
            if self.rwkv:
                total += rwkv_params()
                continue
            if i in attn_set:
                total += attn_params()
            elif self.mamba is not None:
                total += mamba_params(self.mamba)
            if self.moe is not None and i >= self.moe.first_dense and \
                    (i % self.moe.layer_period == self.moe.layer_offset):
                total += moe_ffn(self.moe)
            elif not self.rwkv and (self.mamba is None or i in attn_set or True):
                # non-MoE layers get a dense FFN (jamba: every layer has FFN/MoE)
                if self.moe is None or not (i >= self.moe.first_dense and
                                            i % self.moe.layer_period == self.moe.layer_offset):
                    total += dense_ffn()
        if self.is_encdec:
            # encoder layers: self-attn + ffn; decoder counted above has extra cross-attn
            for _ in range(self.encoder_layers):
                total += 2 * d + d * (nq + 2 * nkv) * hd + nq * hd * d + dense_ffn()
            total += self.n_layers * (d * (nq + 2 * nkv) * hd + nq * hd * d + d)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if i >= m.first_dense and i % m.layer_period == m.layer_offset)
        inactive = n_moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return self.n_params() - inactive


# --------------------------------------------------------------------------
# Input shapes (assigned per-arch shape set)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}

ARCHS = [
    "qwen1_5_0_5b", "deepseek_67b", "stablelm_12b", "qwen2_7b",
    "deepseek_v2_lite", "mixtral_8x22b", "qwen2_vl_72b", "whisper_tiny",
    "jamba_v0_1_52b", "rwkv6_3b",
]

_ALIASES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b", "deepseek-67b": "deepseek_67b",
    "stablelm-12b": "stablelm_12b", "qwen2-7b": "qwen2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite", "deepseek-v2-lite": "deepseek_v2_lite",
    "mixtral-8x22b": "mixtral_8x22b", "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-tiny": "whisper_tiny", "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
}


def _module(name: str):
    key = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def list_archs():
    return list(ARCHS)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Which (arch x shape) cells run (skips are recorded per DESIGN.md §5)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
