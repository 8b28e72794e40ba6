"""The TinyDetector and its weights (port of repro.models)."""
