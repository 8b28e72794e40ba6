"""The round trip's anchor stage on the card, at the benchmark cells' own
shapes (nine 720x1280 cameras, 30-frame chunks, Eq. 3's types from the
rung-1 encode): the stage encodes only the type-1 frames, and its
outputs equal the masked every-frame form's bit for bit, with the pinned
quality (q70) and with the six-rung budget search; the ``blockdct``
forward launches as often as before (1 pinned, 7 with the search).

``masked_anchors`` is that every-frame form, plain PyTorch on the port's
codec; the CPU tests hold the stage against it at small shapes too.  This
file imports no JAX.  On the card: ``python3 -m pytest --noconftest -m
card tests/test_torch_anchor_stage_card.py``; elsewhere the ``card``
fixture skips."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.codec import blockdct as B
from repro_torch.codec import image_codec as I
from repro_torch.core import roundtrip as RT
from repro_torch.core.classification import _classify_host
from repro_torch.kernels import build

f32 = torch.float32
S, T, H, W = 9, 30, 720, 1280
LEVEL, TR1, TR2, LINK_KBPS = 1, 0.06, 0.015, 16000.0 / 9


def masked_anchors(raw, types, video_bits, bw_kbps, cfg):
    """Every frame of raw (S, T, H, W) encoded, the results masked to the
    type-1 frames: (anchor_hd, anchor_bits (S,), anchor_q (S, T))."""
    S_, T_ = types.shape
    is1 = types == 1
    if cfg.anchor_search:
        bits = I.ladder_bits(raw)                            # (S, T, Q)
        n_anchors = B.seq_sum(torch.where(is1, 1.0, 0.0), 1)
        per_anchor = RT.anchor_budget_bits(bw_kbps, video_bits, n_anchors,
                                           T_, cfg.fps)
        rung = I.budget_rung(bits, per_anchor[:, None])
        qs = torch.tensor(I.ANCHOR_QUALITY_LADDER, dtype=f32,
                          device=raw.device)
        tables = B.quant_table(I.ANCHOR_QUALITY_LADDER, raw.device)[rung]
        _, jrec = B.dct_quantize_raster(raw - 128.0, tables)
        jrec = (jrec + 128.0).clamp(0.0, 255.0)
        jbits = bits.gather(-1, rung[..., None])[..., 0]
        frame_q = qs[rung]
    else:
        jrec, jbits = I.jpeg_encode_decode(raw, cfg.anchor_quality)
        frame_q = torch.full((S_, T_), cfg.anchor_quality, dtype=f32,
                             device=raw.device)
    return (torch.where(is1[..., None, None], jrec, 0.0),
            B.seq_sum(torch.where(is1, jbits, 0.0), 1),
            torch.where(is1, frame_q, 0.0))


def spread_bandwidths(raw, types_host, video_bits, fps: float = 30.0):
    """A bandwidth a stream (kbps) that gives its anchors an even share of
    the spare bits halfway between its I-frame's bits at rungs r and r + 1,
    r cycling over the ladder's lower rungs: the search then picks several
    rungs."""
    bits = I.ladder_bits(raw[:, 0]).cpu().numpy()            # (S, Q)
    n_anchors = (types_host == 1).sum(1)
    r = np.arange(raw.shape[0]) % (bits.shape[1] - 1)
    share = (bits[np.arange(len(r)), r] + bits[np.arange(len(r)), r + 1]) / 2
    spare = share * n_anchors + video_bits.cpu().numpy()
    return torch.as_tensor(spare / (1000.0 * types_host.shape[1] / fps),
                           dtype=f32, device=raw.device)


@pytest.fixture(scope="module")
def chunk():
    """One chunk of the cells' nine cameras on the card, with Eq. 3's
    types of its rung-1 encode; skips without a CUDA card, decided when
    the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the chip)")
    from repro_torch.sim.video_source import (generate_chunk_batched,
                                              group_by_signature,
                                              paper_stream_mix)
    k = H / 96
    mix = [dataclasses.replace(sc, min_size=int(sc.min_size * k),
                               max_size=int(sc.max_size * k),
                               speed=sc.speed * k)
           for sc in paper_stream_mix(S, H, W)]
    raw = torch.empty((S, T, H, W), dtype=f32, device="cuda")
    for _, idx in group_by_signature(mix).items():
        raw[idx] = generate_chunk_batched([mix[i] for i in idx], 0, T)[0]
    cfg = RT.RoundtripConfig(level=LEVEL)
    enc = RT._encode_chunk(RT._downscale(raw, LEVEL), cfg.codec_for())
    types_host = _classify_host(enc.frame_diff / 255.0,
                                enc.residual_mag / 255.0, TR1, TR2)[0]
    return raw, types_host, B.seq_sum(enc.bits, 1)


@pytest.mark.card
@pytest.mark.parametrize("search", [False, True], ids=["pinned", "search"])
def test_card_anchor_stage_equals_masked_form(chunk, search):
    raw, types_host, video_bits = chunk
    n1 = int((types_host == 1).sum())
    assert S <= n1 < S * T, n1          # some frames are not anchors
    types = torch.from_numpy(types_host).cuda()
    cfg = RT.RoundtripConfig(level=LEVEL, anchor_search=search)
    bw = spread_bandwidths(raw, types_host, video_bits) if search \
        else torch.full((S,), LINK_KBPS, dtype=f32, device="cuda")
    want = masked_anchors(raw, types, video_bits, bw, cfg)
    build.reset_launches()
    RT.ANCHOR_FRAMES.clear()
    got = RT._anchors(raw, types_host, video_bits, bw, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["blockdct_forward"] == (7 if search else 1)
    assert RT.ANCHOR_FRAMES == {"given": S * T, "encoded": n1}
    for name, a, b in zip(("anchor_hd", "anchor_bits", "anchor_q"), got,
                          want):
        assert torch.equal(a, b), name
    if search:
        assert len(torch.unique(got[2][types == 1])) > 1
