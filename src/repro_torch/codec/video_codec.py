"""Block-based video codec simulation: I/P frames, macroblock motion
vectors and a DCT-quantised residual (port of
``repro.codec.video_codec``).

Chunks are (T, H, W) luma in [0, 255]; the encode runs S streams at once,
(S, T, H, W), its P-frame loop a Python loop over frames.  Each step passes
all S streams as one batch: on CUDA it launches one ``motion_sad`` (in the
config's search and storage dtype), one ``qtransfer`` (motion
compensation) and one ``blockdct`` forward for all S streams, whatever S
is.  The bits and the two mean-|.| features are summed once a chunk, in
two ``seq_sum`` launches, in the reference's order.

Heterogeneous bitrate ladders: ``encode_chunk_ladder_batched`` encodes
streams of mixed rungs (their own LR shapes and quantisers) on one padded
canvas.  Each stream's valid extent (h, w) masks the motion vectors,
coefficients, bits and features, and the padded margin of every frame is
kept an edge replication of the valid region, so a valid macroblock sees
the search windows of an unpadded encode.  Lane s equals ``encode_chunk``
on stream s's own unpadded frames over its valid extent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.codec import blockdct as B
from repro_torch.codec import motion as M
from repro_torch.device import resolve_device

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class VideoCodecConfig:
    """The reference's codec config without ``use_kernel``: on CUDA the
    port always runs its kernels."""
    search_radius: int = 8
    quality: float = 50.0        # quantizer quality factor (QP analogue)
    gop: int = 30                # I-frame period
    dtype: str = "float32"       # search storage dtype: float32 | bfloat16
    search: str = "exhaustive"   # motion search strategy: exhaustive | diamond

    @property
    def search_dtype(self):
        """The motion search's storage dtype: torch.bfloat16 for
        "bfloat16"/"bf16", else None (f32)."""
        if self.dtype in ("bfloat16", "bf16"):
            return torch.bfloat16
        return None


@dataclasses.dataclass
class EncodedChunk:
    """Everything the edge receives for one chunk of one stream; the
    batched encodes give every field a leading stream axis."""
    recon: torch.Tensor          # (T, H, W) decoder reconstruction
    mv: torch.Tensor             # (T, nby, nbx, 2) int32 (frame t-1 -> t)
    residual_q: torch.Tensor     # (T, nblocks, 8, 8) quantized residual coefs
    qtab: torch.Tensor           # (8, 8) quant table
    bits: torch.Tensor           # (T,) per-frame bit cost
    residual_mag: torch.Tensor   # (T,) mean |residual| per frame (R_f feature)
    frame_diff: torch.Tensor     # (T,) mean |frame_t - frame_{t-1}| (X_f)

    def lane(self, s: int) -> "EncodedChunk":
        """Stream s of a batched encode."""
        return EncodedChunk(**{f.name: getattr(self, f.name)[s]
                               for f in dataclasses.fields(self)})


def _extent_masks(Hp: int, Wp: int, extents) -> dict:
    """Validity masks and counts of (S, 2) valid extents (h, w) on an
    (Hp, Wp) canvas, and the flat gather index of the edge replication."""
    dev = extents.device
    h, w = extents[:, 0].long(), extents[:, 1].long()
    mb = M.MB

    def grid(n_y, n_x, hy, wx):
        return (torch.arange(n_y, device=dev)[None, :, None] < hy[:, None,
                                                                  None]) \
            & (torch.arange(n_x, device=dev)[None, None, :] < wx[:, None,
                                                                 None])

    yy = torch.minimum(torch.arange(Hp, device=dev)[None], h[:, None] - 1)
    xx = torch.minimum(torch.arange(Wp, device=dev)[None], w[:, None] - 1)
    return dict(
        pix=grid(Hp, Wp, h, w),
        bm8=grid(Hp // 8, Wp // 8, h // 8, w // 8).reshape(len(h), -1),
        mb=grid(Hp // mb, Wp // mb, h // mb, w // mb),
        n8=(h // 8) * (w // 8),
        nmb=(h // mb) * (w // mb),
        # 1/(h*w) as a correctly rounded f32 reciprocal, as the reference
        recip=torch.ones((), dtype=f32, device=dev) / (h * w).to(f32),
        edge=(yy[:, :, None] * Wp + xx[:, None, :]).reshape(len(h), -1),
    )


def _edge_extend(frames, masks):
    """(S, ..., Hp, Wp) frames with each stream's margin overwritten by the
    edge replication of its valid region (one gather)."""
    S, Hp, Wp = frames.shape[0], frames.shape[-2], frames.shape[-1]
    x = frames.reshape(S, -1, Hp * Wp)
    idx = masks["edge"][:, None].expand(S, x.shape[1], Hp * Wp)
    return x.gather(2, idx).reshape(frames.shape)


def _mean_abs(x, masks=None):
    """mean(|x|) of each frame of (S, ..., H, W) -> (S, ...): fixed 16x16
    tile partials, then the reference's order-stable sum of the tile grid
    (one ``seq_sum`` launch for every frame), times a correctly rounded
    f32 1/(h*w).  With ``masks`` (of :func:`_extent_masks`) the padding is
    zeroed and each stream divides by its own valid area: its zero tiles
    add exact no-ops to the add sequence of the unpadded frame."""
    a = x.abs()
    *lead, H, W = a.shape
    if masks is None:
        recip = float(np.float32(1.0) / np.float32(H * W))  # exact in f32
    else:
        shape = (a.shape[0], *[1] * (a.dim() - 3))
        a = torch.where(masks["pix"].reshape(*shape, H, W), a, 0.0)
        recip = masks["recip"].reshape(shape)
    tiles = a.reshape(*lead, H // M.MB, M.MB, W // M.MB, M.MB).sum(
        dim=(-3, -1))
    return B.seq_sum(tiles, 2) * recip


def _mask_q(q, masks):
    return q if masks is None else torch.where(masks["bm8"][..., None, None],
                                               q, 0.0)


def _encode_chunk(frames, cfg: VideoCodecConfig, extent=None,
                  quality=None) -> EncodedChunk:
    """frames: (S, T, H, W) on the device to encode on -> an EncodedChunk
    with a leading stream axis on every field (qtab (S, 8, 8)).  Frame 0
    of each stream is the I-frame; every later frame is a P-frame
    predicted from the previous reconstruction.

    ``extent`` ((S, 2) int, valid (h, w) a stream) activates the masked
    mixed-ladder form: ``frames`` is a padded canvas, and lane s then
    reproduces the unpadded (h, w) encode on its valid extent (padded MVs
    and coefficients zero, padded recon edge-replicated).  ``quality``
    ((S,) quality factors) overrides ``cfg.quality``, one a stream."""
    S, T, H, W = frames.shape
    dev = frames.device
    frames = frames.to(f32)
    if quality is None:
        qtab = B.quant_table(cfg.quality, dev)
    else:
        qtab = B.quant_table(torch.as_tensor(quality, dtype=f32).reshape(S),
                             dev)
    masks = None
    if extent is not None:
        masks = _extent_masks(H, W, torch.as_tensor(extent, device=dev))
        # whatever the caller padded with, the margin must be the edge
        # replication for the windows to match the unpadded encode
        frames = _edge_extend(frames, masks)
    bm8 = None if masks is None else masks["bm8"]

    q, rec = B.dct_quantize_raster(frames[:, 0] - 128.0, qtab)
    block_bits = [B.block_bits(q, bm8)]
    rec = (rec + 128.0).clamp(0.0, 255.0)
    if masks is not None:
        # the margin's recon is the round trip of the replicated input, not
        # the replication of the valid recon: extend again
        rec = _edge_extend(rec, masks)
    recs, qs = [rec], [_mask_q(q, masks)]
    mvs = [torch.zeros((S, H // M.MB, W // M.MB, 2), dtype=torch.int32,
                       device=dev)]
    resids, diffs = [frames[:, 0] - 128.0], []
    for t in range(1, T):
        frame, prev = frames[:, t], rec
        mv, _ = M.block_sad(frame, prev, cfg.search_radius,
                            dtype=cfg.search_dtype, search=cfg.search)
        if masks is not None:
            mv = torch.where(masks["mb"][..., None], mv, 0)
        pred = M.warp_blocks(prev, mv)
        resid = frame - pred
        q, rec_resid = B.dct_quantize_raster(resid, qtab)
        block_bits.append(B.block_bits(q, bm8))
        rec = (pred + rec_resid).clamp(0.0, 255.0)
        if masks is not None:
            rec = _edge_extend(rec, masks)
        recs.append(rec)
        qs.append(_mask_q(q, masks))
        mvs.append(mv)
        resids.append(resid)
        diffs.append(frame - prev)

    # every frame's bits in one seq_sum, the two features in another
    grid8 = (H // 8, W // 8)
    if masks is None:
        overhead = (H // 8) * (W // 8) * 4.0
        mv_cost = (H // M.MB) * (W // M.MB) * 2 * 3.0   # MV coding proxy
    else:
        overhead = masks["n8"].to(f32)[:, None] * 4.0
        mv_cost = masks["nmb"].to(f32)[:, None] * 6.0   # 2 components x 3
    ent = B.seq_sum(torch.stack(block_bits, 1).reshape(S, T, *grid8), 2) \
        + overhead
    is_p = (torch.arange(T, device=dev) > 0)[None]
    bits = ent + torch.where(is_p, mv_cost, 0.0)
    means = _mean_abs(torch.stack(resids + diffs, 1), masks)
    frame_diff = torch.cat([torch.zeros((S, 1), dtype=f32, device=dev),
                            means[:, T:]], dim=1)
    return EncodedChunk(
        recon=torch.stack(recs, 1), mv=torch.stack(mvs, 1),
        residual_q=torch.stack(qs, 1), qtab=qtab.expand(S, 8, 8),
        bits=bits, residual_mag=means[:, :T], frame_diff=frame_diff)


def encode_chunk(frames, cfg: VideoCodecConfig = VideoCodecConfig(), *,
                 device=None) -> EncodedChunk:
    """frames: (T, H, W) [0..255], numpy or tensor.  Frame 0 is the
    I-frame (chunks align to GOPs).  Runs on CUDA unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, dtype=f32, device=dev)
    return _encode_chunk(frames[None], cfg).lane(0)


def encode_chunk_batched(frames, cfg: VideoCodecConfig = VideoCodecConfig(),
                         *, device=None) -> EncodedChunk:
    """frames: (S, T, H, W) -> one encode of S streams of one shape and
    quality: every field gains a leading stream axis (qtab (S, 8, 8)).
    On CUDA each step launches each kernel once for all S streams."""
    dev = resolve_device(device)
    return _encode_chunk(torch.as_tensor(frames, dtype=f32, device=dev), cfg)


def encode_chunk_ladder_batched(frames, extents, qualities,
                                cfg: VideoCodecConfig = VideoCodecConfig(),
                                *, device=None) -> EncodedChunk:
    """One padded encode of S streams of MIXED ladder rungs.

    frames: (S, T, Hp, Wp), each stream's LR chunk padded onto the common
    canvas (``pad_ladder_batch``); extents: (S, 2) valid (h, w); qualities:
    (S,) quality factors.  Lane s equals ``encode_chunk`` on stream s's
    unpadded frames over the valid extent; padded MVs and coefficients are
    zero and the padded recon is edge-replicated.  ``cfg.quality`` is
    ignored (the per-stream qualities win)."""
    dev = resolve_device(device)
    return _encode_chunk(torch.as_tensor(frames, dtype=f32, device=dev), cfg,
                         extent=torch.as_tensor(extents, device=dev),
                         quality=qualities)


def pad_ladder_batch(chunks, *, device=None):
    """Stack mixed-shape LR chunks ((T, h_s, w_s) each, same T) onto one
    zero-padded canvas: (frames (S, T, Hp, Wp), extents (S, 2) int32) for
    ``encode_chunk_ladder_batched``."""
    dev = resolve_device(device)
    chunks = [torch.as_tensor(c, dtype=f32, device=dev) for c in chunks]
    Hp = max(c.shape[1] for c in chunks)
    Wp = max(c.shape[2] for c in chunks)
    frames = torch.stack([
        torch.nn.functional.pad(c, (0, Wp - c.shape[2], 0, Hp - c.shape[1]))
        for c in chunks])
    extents = torch.tensor([tuple(c.shape[1:]) for c in chunks],
                           dtype=torch.int32, device=dev)
    return frames, extents


def decode_chunk(enc: EncodedChunk):
    """The decoder's frame reconstruction (the encoder's own loop)."""
    return enc.recon


def chunk_psnr(raw, recon):
    """PSNR of each frame: (..., T, H, W) -> (..., T)."""
    mse = (raw.to(f32) - recon.to(f32)).square().mean(dim=(-2, -1))
    return 10.0 * torch.log10(255.0 ** 2 / mse.clamp(min=1e-9))
