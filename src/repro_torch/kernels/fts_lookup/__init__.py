"""Fused FTS lookup: tag compare + victim argmin over one bank row per lane."""
