"""FIGCache-KV decode attention: one query token over the gathered KV."""
