"""Block video codec, JPEG anchors and rate model (port of repro.codec)."""
