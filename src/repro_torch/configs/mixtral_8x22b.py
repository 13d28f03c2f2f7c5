"""Mixtral-8x22B — MoE 8 experts top-2, GQA kv=8, SWA.  [arXiv:2401.04088]"""
from repro_torch.configs import ModelConfig, MoEConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    rope_theta=1_000_000.0, norm_eps=1e-5,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
    figkv=FIGKVConfig(),   # applies to embeddings/expert rows; KV bounded by SWA
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    rope_theta=1_000_000.0, norm_eps=1e-5,
    sliding_window=64,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
