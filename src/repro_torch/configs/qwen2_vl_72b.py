"""Qwen2-VL-72B backbone — dense GQA kv=8, M-RoPE; vision tower is a stub
(input_specs supplies precomputed patch embeddings).  [arXiv:2409.12191]"""
from repro_torch.configs import ModelConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    m_rope=True, mrope_sections=(16, 24, 24), n_vision_tokens=1024,
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="qwen2-vl-72b-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    m_rope=True, mrope_sections=(2, 3, 3), n_vision_tokens=16,
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
