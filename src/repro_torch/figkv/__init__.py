"""FIGCache applied to the KV cache and to embedding gathers."""
from repro_torch.figkv.embed_cache import (EmbedCache, embed_cache_init,
                                           embed_cache_lookup)
from repro_torch.figkv.kv_cache import (FigKVState, figkv_decode_step,
                                        figkv_init, figkv_prefill)

__all__ = ["EmbedCache", "embed_cache_init", "embed_cache_lookup",
           "FigKVState", "figkv_decode_step", "figkv_init", "figkv_prefill"]
