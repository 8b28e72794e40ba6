"""Anchor-free TinyDetector, box decoding, its training loss, greedy NMS
and the F1 metric (port of ``repro.models.detection``).

Parameters are a plain dict of tensors in PyTorch's layout: ``conv{i}``
(c, cin, 3, 3) OIHW with ``bias{i}`` (c,), ``head`` (5, cin, 1, 1) with
``head_b`` (5,).  ``forward`` keeps the reference's NHWC output layout.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TinyDetectorConfig:
    channels: tuple[int, ...] = (16, 32, 64)
    stride: int = 8               # output cell size in px
    dtype: str = "float32"


def param_specs(cfg: TinyDetectorConfig) -> dict:
    """Parameter shapes in the port's (OIHW) layout, in the reference's
    declaration order."""
    p = {}
    cin = 1
    for i, c in enumerate(cfg.channels):
        p[f"conv{i}"] = (c, cin, 3, 3)
        p[f"bias{i}"] = (c,)
        cin = c
    p["head"] = (5, cin, 1, 1)
    p["head_b"] = (5,)
    return p


def init(generator: torch.Generator, cfg: TinyDetectorConfig, *,
         device=None) -> dict:
    """Random parameters by the reference's rule (``repro/models/params.py``
    ``fan_in``): weights ~ N(0, 1/cin), the input-channel count being the
    reference's fan-in, drawn in f32 and rounded to ``cfg.dtype``; biases
    zero.  Drawn on the CPU from ``generator``, then moved to the resolved
    device."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    params = {}
    for name, shape in param_specs(cfg).items():
        if len(shape) == 1:
            params[name] = torch.zeros(shape, dtype=dt)
        else:
            params[name] = (torch.randn(shape, generator=generator,
                                        dtype=f32) / math.sqrt(shape[1])
                            ).to(dt)
    return {k: v.to(dev) for k, v in params.items()}


def layer_strides(cfg: TinyDetectorConfig) -> tuple[int, ...]:
    """Each conv layer's stride: 2 for the first log2(cfg.stride) layers,
    then 1."""
    n_down = {2: 1, 4: 2, 8: 3}[cfg.stride]
    return tuple(2 if i < n_down else 1 for i in range(len(cfg.channels)))


def conv_layer(x, w, b, stride: int):
    """One conv layer on NCHW input: XLA "SAME" zero padding, a 3x3 conv
    at ``stride``, + bias, ReLU."""
    ph = L.same_pad(x.shape[2], w.shape[2], stride)
    pw = L.same_pad(x.shape[3], w.shape[3], stride)
    return F.relu(F.conv2d(F.pad(x, (*pw, *ph)), w, b, stride=stride))


def forward(params: dict, cfg: TinyDetectorConfig, frames):
    """frames: (B, H, W) [0..255] -> (B, H/s, W/s, 5) raw head output.

    Channels: [objectness logit, dy, dx, log h, log w].  The input is f32
    whatever the config, so non-f32 weights raise ``TypeError``, as the
    reference's convolution does on mixed dtypes.
    """
    x = (frames.to(f32) / 255.0 - 0.5)[:, None]
    mixed = sorted({str(w.dtype).removeprefix("torch.")
                    for w in params.values()
                    if w.dim() == 4 and w.dtype != f32})
    if mixed:
        raise TypeError("the convolution requires arguments to have the "
                        f"same dtypes, got float32, {', '.join(mixed)}")
    for i, stride in enumerate(layer_strides(cfg)):
        x = conv_layer(x, params[f"conv{i}"], params[f"bias{i}"], stride)
    x = F.conv2d(x, params["head"], params["head_b"])
    return x.permute(0, 2, 3, 1)


def decode_boxes(raw, cfg: TinyDetectorConfig):
    """-> (boxes (B, Nc, 4) cxcywh px, scores (B, Nc)).  Nc = all cells."""
    B, hc, wc, _ = raw.shape
    s = cfg.stride
    dev = raw.device
    obj = torch.sigmoid(raw[..., 0])
    cy = (torch.arange(hc, dtype=f32, device=dev)[None, :, None] + 0.5
          + torch.tanh(raw[..., 1])) * s
    cx = (torch.arange(wc, dtype=f32, device=dev)[None, None, :] + 0.5
          + torch.tanh(raw[..., 2])) * s
    h = torch.exp(raw[..., 3].clamp(-3, 3)) * s
    w = torch.exp(raw[..., 4].clamp(-3, 3)) * s
    boxes = torch.stack([cy, cx, h, w], dim=-1)
    return boxes.reshape(B, -1, 4), obj.reshape(B, -1)


def _cell_targets(boxes, valid, hc: int, wc: int, stride: int):
    """Rasterise GT boxes onto the output grid: boxes (..., N, 4) cxcywh,
    valid (..., N) -> (tgt (..., hc, wc, 4) the nearest valid box of each
    cell centre, inside (..., hc, wc) whether the centre lies in it).  The
    nearest box is the first on ties, as ``jnp.argmin``."""
    dev = boxes.device
    cy = ((torch.arange(hc, dtype=f32, device=dev) + 0.5) * stride)[:, None]
    cx = ((torch.arange(wc, dtype=f32, device=dev) + 0.5) * stride)[None, :]
    d2 = (boxes[..., :, None, None, 0] - cy).square() \
        + (boxes[..., :, None, None, 1] - cx).square()     # (..., N, hc, wc)
    d2 = torch.where(valid[..., :, None, None], d2, torch.inf)
    nearest_d2, nearest = d2.min(dim=-3)                 # first on ties
    idx = nearest.reshape(*nearest.shape[:-2], hc * wc, 1).expand(
        *nearest.shape[:-2], hc * wc, 4)
    tgt = boxes.gather(-2, idx).reshape(*nearest.shape, 4)
    inside = ((cy - tgt[..., 0]).abs() <= tgt[..., 2] / 2) \
        & ((cx - tgt[..., 1]).abs() <= tgt[..., 3] / 2) \
        & torch.isfinite(nearest_d2)
    return tgt, inside


def loss_fn(params: dict, cfg: TinyDetectorConfig, frames, boxes, valid):
    """frames (B, H, W); boxes (B, N, 4); valid (B, N).  Objectness
    log-loss over every cell plus the box regression over the positive
    cells; differentiable by autograd through the plain detector."""
    raw = forward(params, cfg, frames)
    B, hc, wc, _ = raw.shape
    s = cfg.stride
    dev = raw.device
    tgt, pos = _cell_targets(boxes.to(f32), valid.bool(), hc, wc, s)
    pos = pos.to(f32)
    obj_logit = raw[..., 0]
    obj_loss = (obj_logit.clamp(min=0) - obj_logit * pos
                + torch.log1p(torch.exp(-obj_logit.abs()))).mean()
    cyc = (torch.arange(hc, dtype=f32, device=dev)[None, :, None] + 0.5) * s
    cxc = (torch.arange(wc, dtype=f32, device=dev)[None, None, :] + 0.5) * s
    t_dy = (tgt[..., 0] - cyc) / s
    t_dx = (tgt[..., 1] - cxc) / s
    t_lh = torch.log((tgt[..., 2] / s).clamp(min=1e-3))
    t_lw = torch.log((tgt[..., 3] / s).clamp(min=1e-3))
    reg = (torch.tanh(raw[..., 1]) - t_dy.clamp(-1, 1)).square() \
        + (torch.tanh(raw[..., 2]) - t_dx.clamp(-1, 1)).square() \
        + (raw[..., 3].clamp(-3, 3) - t_lh.clamp(-3, 3)).square() \
        + (raw[..., 4].clamp(-3, 3) - t_lw.clamp(-3, 3)).square()
    reg_loss = (reg * pos).sum() / pos.sum().clamp(min=1.0)
    return obj_loss + 0.5 * reg_loss


def iou_cxcywh(a, b):
    """a: (..., 4), b: (..., 4) -> IoU."""
    ay0, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ax0, ax1 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    by0, by1 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    bx0, bx1 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iy = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp(min=0)
    ix = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp(min=0)
    inter = iy * ix
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / union.clamp(min=1e-9)


def greedy_nms(boxes, scores, iou_thresh: float = 0.5, top_k: int = 32):
    """NMS over the ``top_k`` highest-scoring cells of each frame: boxes
    (..., N, 4), scores (..., N) -> (the top boxes (..., k, 4), their scores
    zeroed where suppressed (..., k)), k = min(top_k, N).  The top cells
    come from a stable descending sort, so ties keep the lower index
    first, as ``lax.top_k``.

    The reference's loop tests cell i with ``iou_cxcywh(bx[i][None],
    bx)[0]``, its overlap with the top cell alone, and the top cell is
    never suppressed: so a cell is suppressed exactly when it overlaps the
    top cell by more than ``iou_thresh``, which is what this computes."""
    k = min(top_k, scores.shape[-1])
    sc, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    sc, idx = sc[..., :k], idx[..., :k]
    bx = boxes.gather(-2, idx[..., None].expand(*idx.shape, 4))
    overlap = iou_cxcywh(bx, bx[..., :1, :])             # (..., k)
    rank = torch.arange(k, device=scores.device)
    suppressed = (overlap > iou_thresh) & (rank > 0)
    return bx, sc * torch.where(suppressed, 0.0, 1.0)


def f1_score(pred_boxes, pred_scores, gt_boxes, gt_valid,
             iou_thresh: float = 0.5, score_thresh: float = 0.5):
    """Greedy-matching F1@IoU per frame.  pred_boxes (B, P, 4),
    pred_scores (B, P), gt_boxes (B, G, 4), gt_valid (B, G) -> (B,).

    min(P, G) rounds: each takes the highest remaining IoU (first index on
    ties, as jnp.argmax), counts a hit when it reaches ``iou_thresh``, and
    then clears that prediction's row and that GT's column."""
    conf = pred_scores > score_thresh
    valid = gt_valid.to(f32)
    iou = iou_cxcywh(pred_boxes[:, :, None], gt_boxes[:, None])   # (B, P, G)
    iou = iou * conf[:, :, None] * valid[:, None, :]
    B, P, G = iou.shape
    rows = torch.arange(B, device=iou.device)
    tp = torch.zeros(B, dtype=f32, device=iou.device)
    for _ in range(min(P, G)):
        flat = iou.reshape(B, -1).argmax(dim=1)
        pi, gi = flat // G, flat % G
        hit = iou[rows, pi, gi] >= iou_thresh
        keep_row = (torch.arange(P, device=iou.device)[None] != pi[:, None])
        keep_col = (torch.arange(G, device=iou.device)[None] != gi[:, None])
        cleared = iou * keep_row[:, :, None] * keep_col[:, None, :]
        iou = torch.where(hit[:, None, None], cleared, iou)
        tp = tp + hit.to(f32)
    n_pred = conf.sum(1).to(f32)
    n_gt = valid.sum(1)
    prec = tp / n_pred.clamp(min=1e-9)
    rec = tp / n_gt.clamp(min=1e-9)
    f1 = 2 * prec * rec / (prec + rec).clamp(min=1e-9)
    return torch.where(n_gt > 0, f1, torch.where(n_pred > 0, 0.0, 1.0))
