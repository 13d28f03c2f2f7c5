"""Whisper-tiny — enc-dec audio; conv frontend is a stub (input_specs supplies
precomputed frame embeddings).  [arXiv:2212.04356]"""
from repro_torch.configs import ModelConfig, FIGKVConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    norm_eps=1e-5,
    encoder_layers=4, n_audio_frames=1500,
    figkv=FIGKVConfig(),
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512,
    rope_theta=0.0, norm_eps=1e-5,
    encoder_layers=2, n_audio_frames=32,
    figkv=FIGKVConfig(seg_tokens=4, fast_rows=4, segs_per_row=2),
)
