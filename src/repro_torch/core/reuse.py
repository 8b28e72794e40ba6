"""Inference-result reuse, paper §IV-B pipeline ③ (port of
``repro.core.reuse``): take the last inference frame's detections and
shift each box by the mean motion vector of the macroblocks it covers.
Every function takes leading stream axes; the loop over a chunk's frames
is T steps for any number of streams."""
from __future__ import annotations

import torch

from repro_torch.codec.motion import MB

f32 = torch.float32


def shift_boxes(boxes, scores, mv):
    """boxes: (..., N, 4) cxcywh px; mv: (..., nby, nbx, 2) codec motion
    vectors.

    Codec convention: pred(y) = ref(y + mv), so an object moves by -mv and
    each box shifts by -mean(mv) over the blocks it covers.  The block
    mask is separable (rows x columns), so the masked MV sums are two small
    products instead of an (N, nby, nbx) mask; MVs are integers, so every
    sum is exact in f32 and equals the reference's.
    """
    nby, nbx = mv.shape[-3:-1]
    dev = boxes.device
    cy = (torch.arange(nby, dtype=f32, device=dev) + 0.5) * MB
    cx = (torch.arange(nbx, dtype=f32, device=dev) + 0.5) * MB
    in_y = ((cy - boxes[..., 0:1]).abs()
            <= boxes[..., 2:3] / 2 + MB / 2).to(f32)         # (..., N, nby)
    in_x = ((cx - boxes[..., 1:2]).abs()
            <= boxes[..., 3:4] / 2 + MB / 2).to(f32)         # (..., N, nbx)
    m = mv.to(f32)
    n = (in_y.sum(-1) * in_x.sum(-1)).clamp(min=1e-9)
    dy = ((in_y @ m[..., 0]) * in_x).sum(-1) / n
    dx = ((in_y @ m[..., 1]) * in_x).sum(-1) / n
    zero = torch.zeros_like(dy)
    return boxes - torch.stack([dy, dx, zero, zero], dim=-1), scores


def reuse_chunk(types, mvs, infer_boxes, infer_scores, init_boxes=None,
                init_scores=None):
    """Propagate detections through the type-3 frames of a chunk.

    types: (..., T); mvs: (..., T, nby, nbx, 2) frame-to-previous MVs;
    infer_boxes/scores: (..., T, N, 4)/(..., T, N), valid at type-1/2
    frames.  ``init_boxes``/``init_scores`` ((..., N, 4)/(..., N)) seed
    the carry with the previous chunk's last detections, so type-3 frames
    at a chunk boundary keep tracking across chunks (default: frame 0's
    own).  Returns per-frame (boxes, scores).
    """
    T = types.shape[-1]
    boxes = infer_boxes[..., 0, :, :] if init_boxes is None else init_boxes
    scores = infer_scores[..., 0, :] if init_scores is None else init_scores
    out_boxes, out_scores = [], []
    for i in range(T):
        fresh = (types[..., i] != 3)[..., None]
        shifted, sc = shift_boxes(boxes, scores, mvs[..., i, :, :, :])
        boxes = torch.where(fresh[..., None], infer_boxes[..., i, :, :],
                            shifted)
        scores = torch.where(fresh, infer_scores[..., i, :], sc)
        out_boxes.append(boxes)
        out_scores.append(scores)
    return torch.stack(out_boxes, dim=-3), torch.stack(out_scores, dim=-2)
