"""Synthetic video sources (port of repro.sim)."""
