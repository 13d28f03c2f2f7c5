"""DeepSeek-67B — dense llama-arch, GQA kv=8.  [arXiv:2401.02954]"""
from repro_torch.configs import ModelConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400,
    rope_theta=10000.0, norm_eps=1e-6,
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="deepseek-67b-reduced", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=172, vocab_size=512,
    rope_theta=10000.0, norm_eps=1e-6,
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
