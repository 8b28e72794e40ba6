"""Plain reference of the encode: the ladder downscale, the 8x8 DCT with
quantisation, the bit model, the motion search and compensation, and the
I/P encode of S streams (the semantics of ``repro.codec``).

Plain PyTorch on whatever device its inputs are on; no kernel, no code of
the program.  Every sum follows the order that the codec states, so that
a correct program agrees with it bit for bit:

* a DCT product sums its 8 terms in index order with one rounding a term
  (a fused multiply-add chain: each product is exact in float64 and the
  sum is rounded to float32 once a term), quotients are IEEE divisions,
  and quantisation rounds half to even;
* a SAD sums its 16 x 16 absolute differences in four row groups (rows
  g, g + 4, g + 8, g + 12, each row's columns in order), then adds the
  four partials in group order; the least SAD wins, the first candidate
  in dy-major order on ties;
* ``seq_sum`` scans each row left to right, then the row totals.

``search_store`` is the storage type of the search's planes: "float32",
"bfloat16" or "uint8" (the control's step below bfloat16).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

f32 = torch.float32
f64 = torch.float64
MB = 16

JPEG_LUMA_Q50 = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)


def dct_matrix(device) -> torch.Tensor:
    """The orthonormal 8-point DCT-II matrix D (f32, y = D x D^T), built
    in numpy float32."""
    k = np.arange(8, dtype=np.float32)[:, None]
    i = np.arange(8, dtype=np.float32)[None, :]
    d = np.cos((2 * i + 1) * k * math.pi / 16) * math.sqrt(2.0 / 8)
    d[0] *= 1.0 / math.sqrt(2.0)
    return torch.from_numpy(d).to(device)


def quant_table(quality, device) -> torch.Tensor:
    """(..., 8, 8) f32 tables of JPEG quality factors (Annex K scaling,
    floored at 1)."""
    q = torch.as_tensor(quality, dtype=f32).cpu().clamp(1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q) / 100.0
    qtab = torch.from_numpy(JPEG_LUMA_Q50) * scale[..., None, None]
    return qtab.clamp(min=1.0).to(device)


def _chain(pairs):
    """sum_k a_k * b_k as a fused multiply-add chain from 0, in order."""
    acc = None
    for a, b in pairs:
        p = a.to(f64) * b.to(f64)
        acc = p.to(f32) if acc is None else (p + acc.to(f64)).to(f32)
    return acc


def _inverse_tiles(a, d):
    """(..., 8, 8) dequantised coefficients a -> D^T a D, by columns
    (z = D^T a) then rows (rec = z D)."""
    z = _chain((d[k, :, None], a[..., k, None, :]) for k in range(8))
    return _chain((z[..., :, k, None], d[None, k, :]) for k in range(8))


def _forward_tiles(x, d, qt):
    """(..., 8, 8) tiles -> (q = round(D x D^T / qt), rec)."""
    b = _chain((x[..., :, k, None], d[None, :, k]) for k in range(8))
    y = _chain((d[:, k, None], b[..., k, None, :]) for k in range(8))
    q = torch.round(y / qt)
    return q, _inverse_tiles(q * qt, d)


def blockify(img):
    """(..., H, W) -> (..., nb, 8, 8), tiles row-major."""
    *lead, H, W = img.shape
    x = img.reshape(*lead, H // 8, 8, W // 8, 8)
    return x.transpose(-3, -2).reshape(*lead, -1, 8, 8)


def unblockify(blocks, H: int, W: int):
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, H // 8, W // 8, 8, 8)
    return x.transpose(-3, -2).reshape(*lead, H, W)


def _tables(qtab, lead):
    """One (8, 8) table or tables over the frames' leading axes ->
    (F, 1, 8, 8) or (8, 8)."""
    if qtab.dim() == 2 or qtab.shape[:-2].numel() == 1:
        return qtab.reshape(8, 8)
    return qtab.expand(*lead, 8, 8).reshape(-1, 1, 8, 8)


def dct_quantize(frames, qtab, frames_a_block: int = 32):
    """(..., H, W) frames -> (q (..., nb, 8, 8), rec (..., H, W)), a few
    frames at a time (each frame's result is its own)."""
    *lead, H, W = frames.shape
    d = dct_matrix(frames.device)
    x = frames.reshape(-1, H, W)
    qt = _tables(qtab, lead)
    qs, recs = [], []
    for a in range(0, x.shape[0], frames_a_block):
        t = qt if qt.dim() == 2 else qt[a:a + frames_a_block]
        q, rec = _forward_tiles(blockify(x[a:a + frames_a_block]), d, t)
        qs.append(q)
        recs.append(unblockify(rec, H, W))
    return (torch.cat(qs).reshape(*lead, -1, 8, 8),
            torch.cat(recs).reshape(frames.shape))


def dequant_idct(q, qtab, H: int, W: int, frames_a_block: int = 32):
    """(..., nb, 8, 8) quantised coefficients -> (..., H, W)."""
    lead = q.shape[:-3]
    d = dct_matrix(q.device)
    x = q.reshape(-1, *q.shape[-3:])
    qt = _tables(qtab, lead)
    out = []
    for a in range(0, x.shape[0], frames_a_block):
        t = qt if qt.dim() == 2 else qt[a:a + frames_a_block]
        out.append(unblockify(_inverse_tiles(x[a:a + frames_a_block] * t, d),
                              H, W))
    return torch.cat(out).reshape(*lead, H, W)


def seq_sum(v, dims: int):
    """Order-stable f32 sum over the trailing ``dims`` (1 or 2) axes: each
    row scanned left to right, then the row totals in row order."""
    lead = v.shape[:v.dim() - dims]
    g = v.to(f32).reshape(-1, *((1, v.shape[-1]) if dims == 1
                                else v.shape[-2:]))
    rows = torch.zeros(g.shape[:2], dtype=f32, device=v.device)
    for c in range(g.shape[2]):
        rows = rows + g[:, :, c]
    total = torch.zeros(g.shape[0], dtype=f32, device=v.device)
    for r in range(g.shape[1]):
        total = total + rows[:, r]
    return total.reshape(lead)


def block_bits(q, block_mask=None):
    """Each 8x8 block's bits without the 4-bit overhead: 2 log2(1 + |q|)
    + 1 a nonzero coefficient."""
    a = q.abs()
    bits = torch.where(a > 0, 2.0 * torch.log2(1.0 + a) + 1.0, 0.0)
    per_block = bits.sum(dim=(-2, -1))
    if block_mask is not None:
        per_block = torch.where(block_mask, per_block, 0.0)
    return per_block


def entropy_bits(q, grid):
    return seq_sum(block_bits(q).reshape(*q.shape[:-3], *grid), 2) \
        + q.shape[-3] * 4.0


def jpeg(frames, quality):
    """JPEG round trip of (..., H, W) frames at one quality: (rec, bits)."""
    H, W = frames.shape[-2:]
    q, rec = dct_quantize(frames - 128.0, quant_table(quality,
                                                      frames.device))
    return (rec + 128.0).clamp(0.0, 255.0), entropy_bits(q, (H // 8, W // 8))


def downscale(frames, level: int, ladder):
    """(T, H, W) -> the rung's LR frames: crop to whole pooling windows,
    average."""
    T, H, W = frames.shape
    h, w = lr_shape(ladder[level][1], H, W)
    fy, fx = H // h, W // w
    return frames[:, :fy * h, :fx * w].reshape(T, h, fy, w, fx).mean(
        dim=(2, 4))


def lr_shape(scale: float, H: int, W: int) -> tuple[int, int]:
    return max(int(H * scale) // 16 * 16, 16), max(int(W * scale) // 16 * 16,
                                                   16)


# ------------------------------------------------------------ motion search
def _stored(x, store: str):
    if store == "bfloat16":
        return x.to(torch.bfloat16).to(f32)
    if store == "uint8":
        return x.round().clamp(0.0, 255.0)
    return x.to(f32)


def sad_table(cur, ref, radius: int, store: str):
    """(S, H, W) current and reference frames -> (S, nby, nbx, 2R+1, 2R+1)
    SADs of every candidate (dy, dx), each summed in the stated order
    against the edge-replicated reference."""
    cur, ref = _stored(cur, store), _stored(ref, store)
    S, H, W = cur.shape
    nby, nbx = H // MB, W // MB
    side, win = 2 * radius + 1, MB + 2 * radius
    refp = F.pad(ref[:, None], (radius,) * 4, mode="replicate")[:, 0]
    wins = refp.unfold(1, win, MB).unfold(2, win, MB)   # (S, nby, nbx, w, w)
    curb = cur.reshape(S, nby, MB, nbx, MB).permute(0, 1, 3, 2, 4)
    parts = []
    for g in range(4):
        acc = torch.zeros((S, nby, nbx, side, side), dtype=f32,
                          device=cur.device)
        for r in range(g, MB, 4):
            for k in range(MB):
                c = curb[:, :, :, r, k, None, None]
                acc = acc + (c - wins[:, :, :, r:r + side, k:k + side]).abs()
        parts.append(acc)
    return ((parts[0] + parts[1]) + parts[2]) + parts[3]


def diamond_steps(radius: int) -> tuple:
    s = 1
    while s * 2 <= radius:
        s *= 2
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    return tuple(steps)


def motion_search(cur, ref, radius: int, search: str, store: str):
    """-> mv (S, nby, nbx, 2) int32 (dy, dx).  Exhaustive: the least SAD
    of every candidate, the first in dy-major order on ties.  Diamond:
    the centre, then at each step the 3x3 probes around the best offset
    found before the step, dy-major, clipped to +-R, a strict <."""
    table = sad_table(cur, ref, radius, store)
    S, nby, nbx, side, _ = table.shape
    flat = table.reshape(S, nby, nbx, side * side)
    if search == "exhaustive":
        best = flat.min(dim=-1, keepdim=True).values
        idx = (flat == best).to(torch.int8).argmax(dim=-1)
        mv = torch.stack([idx // side - radius, idx % side - radius], -1)
        return mv.to(torch.int32)
    if search != "diamond":
        raise ValueError(f"unknown search {search!r}")

    def at(oy, ox):
        i = ((oy + radius) * side + (ox + radius))[..., None]
        return flat.gather(-1, i)[..., 0]

    by = torch.zeros((S, nby, nbx), dtype=torch.long, device=cur.device)
    bx = torch.zeros_like(by)
    best = at(by, bx)
    for s in diamond_steps(radius):
        cy, cx = by, bx
        for py in (-s, 0, s):
            for px in (-s, 0, s):
                oy = (cy + py).clamp(-radius, radius)
                ox = (cx + px).clamp(-radius, radius)
                sad = at(oy, ox)
                better = sad < best
                best = torch.where(better, sad, best)
                by = torch.where(better, oy, by)
                bx = torch.where(better, ox, bx)
    return torch.stack([by, bx], -1).to(torch.int32)


def _padded_start(s, n: int):
    """A 16-wide slice's start on an edge-padded (n + 32) axis: negative
    starts count from the end, then clamp to [0, n + 16]."""
    return torch.where(s < 0, s + n + 2 * MB, s).clamp(0, n + MB)


def warp(src, mv, resid=None):
    """Each 16x16 block of (B, H, W) ``src`` gathered at its motion
    vector, each pixel edge-replicated; plus ``resid`` and clipped to
    [0, 255] when given."""
    B, H, W = src.shape
    dev = src.device
    y = torch.arange(H, device=dev)
    x = torch.arange(W, device=dev)
    by, i = (y // MB)[:, None], (y % MB)[:, None]
    bx, j = (x // MB)[None, :], (x % MB)[None, :]
    m = mv.long()
    dy = m[:, :, :, 0][:, y // MB][:, :, x // MB]
    dx = m[:, :, :, 1][:, y // MB][:, :, x // MB]
    sy = (_padded_start(by * MB + MB + dy, H) - MB + i).clamp(0, H - 1)
    sx = (_padded_start(bx * MB + MB + dx, W) - MB + j).clamp(0, W - 1)
    out = src.to(f32).reshape(B, H * W).gather(
        1, (sy * W + sx).reshape(B, H * W)).reshape(B, H, W)
    if resid is not None:
        out = (out + resid.to(f32)).clamp(0.0, 255.0)
    return out


# ------------------------------------------------------------- the encode
def extent_masks(Hp: int, Wp: int, extents) -> dict:
    """Masks and counts of (S, 2) valid (h, w) extents on an (Hp, Wp)
    canvas, and the flat index of the margin's edge replication."""
    dev = extents.device
    h, w = extents[:, 0].long(), extents[:, 1].long()

    def grid(n_y, n_x, hy, wx):
        return (torch.arange(n_y, device=dev)[None, :, None]
                < hy[:, None, None]) \
            & (torch.arange(n_x, device=dev)[None, None, :]
               < wx[:, None, None])

    yy = torch.minimum(torch.arange(Hp, device=dev)[None], h[:, None] - 1)
    xx = torch.minimum(torch.arange(Wp, device=dev)[None], w[:, None] - 1)
    return dict(
        pix=grid(Hp, Wp, h, w),
        bm8=grid(Hp // 8, Wp // 8, h // 8, w // 8).reshape(len(h), -1),
        mb=grid(Hp // MB, Wp // MB, h // MB, w // MB),
        n8=(h // 8) * (w // 8), nmb=(h // MB) * (w // MB),
        recip=torch.ones((), dtype=f32, device=dev) / (h * w).to(f32),
        edge=(yy[:, :, None] * Wp + xx[:, None, :]).reshape(len(h), -1))


def edge_extend(frames, masks):
    S, Hp, Wp = frames.shape[0], frames.shape[-2], frames.shape[-1]
    x = frames.reshape(S, -1, Hp * Wp)
    idx = masks["edge"][:, None].expand(S, x.shape[1], Hp * Wp)
    return x.gather(2, idx).reshape(frames.shape)


def mean_abs(x, masks=None):
    """mean |x| of each frame of (S, n, H, W): 16x16 tile partials, their
    grid summed in order, times a correctly rounded f32 1 / (h w)."""
    a = x.abs()
    *lead, H, W = a.shape
    if masks is None:
        recip = float(np.float32(1.0) / np.float32(H * W))
    else:
        shape = (a.shape[0], *[1] * (a.dim() - 3))
        a = torch.where(masks["pix"].reshape(*shape, H, W), a, 0.0)
        recip = masks["recip"].reshape(shape)
    tiles = a.reshape(*lead, H // MB, MB, W // MB, MB).sum(dim=(-3, -1))
    return seq_sum(tiles, 2) * recip


def encode(frames, quality, codec: dict, extent=None, search_store=None):
    """(S, T, H, W) LR frames -> dict(recon, mv, residual_q, qtab (S, 8,
    8), bits (S, T), residual_mag (S, T), frame_diff (S, T)).  Frame 0 is
    the I-frame, every later frame a P-frame predicted from the previous
    reconstruction.  ``quality``: one quality factor or (S,) of them;
    ``extent``: (S, 2) valid extents of a padded canvas (the margin kept
    an edge replication, its vectors and coefficients zero)."""
    S, T, H, W = frames.shape
    dev = frames.device
    frames = frames.to(f32)
    qtab = quant_table(torch.as_tensor(quality, dtype=f32).reshape(-1), dev)
    qtab = qtab.reshape(8, 8) if qtab.shape[0] == 1 else qtab
    store = search_store or codec["dtype"]
    masks = None
    if extent is not None:
        masks = extent_masks(H, W, extent)
        frames = edge_extend(frames, masks)
    bm8 = None if masks is None else masks["bm8"]

    def mask_q(q):
        return q if masks is None else torch.where(
            masks["bm8"][..., None, None], q, 0.0)

    q, rec = dct_quantize(frames[:, 0] - 128.0, qtab)
    block = [block_bits(q, bm8)]
    rec = (rec + 128.0).clamp(0.0, 255.0)
    if masks is not None:
        rec = edge_extend(rec, masks)
    recs, qs = [rec], [mask_q(q)]
    mvs = [torch.zeros((S, H // MB, W // MB, 2), dtype=torch.int32,
                       device=dev)]
    resids, diffs = [frames[:, 0] - 128.0], []
    for t in range(1, T):
        frame, prev = frames[:, t], rec
        mv = motion_search(frame, prev, codec["search_radius"],
                           codec["search"], store)
        if masks is not None:
            mv = torch.where(masks["mb"][..., None], mv, 0)
        pred = warp(prev, mv)
        resid = frame - pred
        q, rec_resid = dct_quantize(resid, qtab)
        block.append(block_bits(q, bm8))
        rec = (pred + rec_resid).clamp(0.0, 255.0)
        if masks is not None:
            rec = edge_extend(rec, masks)
        recs.append(rec)
        qs.append(mask_q(q))
        mvs.append(mv)
        resids.append(resid)
        diffs.append(frame - prev)
    grid8 = (H // 8, W // 8)
    if masks is None:
        overhead = (H // 8) * (W // 8) * 4.0
        mv_cost = (H // MB) * (W // MB) * 2 * 3.0
    else:
        overhead = masks["n8"].to(f32)[:, None] * 4.0
        mv_cost = masks["nmb"].to(f32)[:, None] * 6.0
    ent = seq_sum(torch.stack(block, 1).reshape(S, T, *grid8), 2) + overhead
    is_p = (torch.arange(T, device=dev) > 0)[None]
    bits = ent + torch.where(is_p, mv_cost, 0.0)
    means = mean_abs(torch.stack(resids + diffs, 1), masks)
    frame_diff = torch.cat([torch.zeros((S, 1), dtype=f32, device=dev),
                            means[:, T:]], dim=1)
    return dict(recon=torch.stack(recs, 1), mv=torch.stack(mvs, 1),
                residual_q=torch.stack(qs, 1),
                qtab=qtab.expand(S, 8, 8), bits=bits,
                residual_mag=means[:, :T], frame_diff=frame_diff)
