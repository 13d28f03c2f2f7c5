"""Jamba-v0.1 (52B) — hybrid Mamba+attention 1:7, MoE 16e top-2.
[arXiv:2403.19887]   attn on layers i%8==4; MoE on layers i%2==1.
"""
from repro_torch.configs import ModelConfig, MoEConfig, MambaConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    rope_theta=0.0,             # jamba uses no positional encodings in attn
    norm_eps=1e-6,
    attn_layer_period=8, attn_layer_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336,
                  layer_period=2, layer_offset=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="jamba-reduced", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    rope_theta=0.0, norm_eps=1e-6,
    attn_layer_period=4, attn_layer_offset=2,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                  layer_period=2, layer_offset=1),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
