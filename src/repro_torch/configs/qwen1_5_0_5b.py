"""Qwen1.5-0.5B — dense, GQA kv=16 (MHA), QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs import ModelConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    tie_embeddings=True,
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="qwen1.5-0.5b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=176, vocab_size=512,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    tie_embeddings=True,
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
