"""Classification, decode-execute pipelines and the round trip (port of repro.core)."""
