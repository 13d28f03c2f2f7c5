"""Prefill flash attention: causal and sliding-window masks, grouped KV
heads, any sequence length."""
