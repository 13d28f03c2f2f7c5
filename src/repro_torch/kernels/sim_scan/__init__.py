"""Whole-trace simulator replay: every step of a lane trace in one launch,
the fused FTS lookup inlined."""
