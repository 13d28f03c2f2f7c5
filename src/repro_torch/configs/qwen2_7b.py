"""Qwen2-7B — dense, GQA kv=4, QKV bias.  [arXiv:2407.10671]

28 q-heads are zero-padded to 32 for 16-way TP (exact function; see
DESIGN.md §4); kv heads replicated 4 -> 16 at TP time.
"""
from repro_torch.configs import ModelConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="qwen2-7b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=7, n_kv_heads=1, head_dim=16,
    d_ff=176, vocab_size=512,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
