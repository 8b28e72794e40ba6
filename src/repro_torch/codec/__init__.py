"""Block video codec, JPEG anchors and rate model (port of repro.codec)."""
from repro_torch.codec.image_codec import jpeg_bits, jpeg_encode_decode  # noqa: F401
from repro_torch.codec.rate_model import (QUALITY_LADDER,  # noqa: F401
                                          ladder_for_bandwidth)
from repro_torch.codec.video_codec import (VideoCodecConfig,  # noqa: F401
                                           decode_chunk, encode_chunk)
