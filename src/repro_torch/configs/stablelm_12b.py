"""StableLM-2-12B — dense, GQA kv=8.  [hf:stabilityai/stablelm-2-12b family]"""
from repro_torch.configs import ModelConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    rope_theta=10000.0, norm_eps=1e-5,
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="stablelm-12b-reduced", family="dense",
    n_layers=2, d_model=80, n_heads=4, n_kv_heads=2,
    d_ff=216, vocab_size=512,
    rope_theta=10000.0, norm_eps=1e-5,
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
