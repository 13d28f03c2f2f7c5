"""RWKV-6 "Finch" 3B — attention-free SSM with data-dependent decay.
[arXiv:2404.05892]   head_size=64 -> 40 heads at d_model=2560.
"""
from repro_torch.configs import ModelConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    rope_theta=0.0, norm_eps=1e-5,
    rwkv=True,
    figkv=FIGKVConfig(),      # applies to embedding gather only (attn-free)
)

REDUCED = ModelConfig(
    name="rwkv6-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=224, vocab_size=512,
    rope_theta=0.0, norm_eps=1e-5,
    rwkv=True,
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
