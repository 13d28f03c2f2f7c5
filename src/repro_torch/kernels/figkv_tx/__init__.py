"""FIGCache-KV decode step: the tag-store transaction and the K/V moves of
every sequence in one launch."""
