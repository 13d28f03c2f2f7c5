"""DeepSeek-V2-Lite (16B) — MoE + MLA.  [arXiv:2405.04434]

MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64, v=128.
MoE: 2 shared + 64 routed, top-6, expert ffn 1408; first layer dense
(d_ff 10944 in HF config; we use cfg.d_ff*? -> kept as dense_ffn with
d_ff_dense).  The assignment line's "160 routed" is full V2; lite=64 (HF).
"""
from repro_torch.configs import ModelConfig, MoEConfig, MLAConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,             # dense-FFN layers (layer 0)
    vocab_size=102400,
    rope_theta=10000.0, norm_eps=1e-6,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  layer_period=1, layer_offset=0, first_dense=1),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512,
    rope_theta=10000.0, norm_eps=1e-6,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=48, n_shared=1,
                  layer_period=1, layer_offset=0, first_dense=1),
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
