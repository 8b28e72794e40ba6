"""Hybrid decoder + the 3 execution pipelines, paper §IV-B Fig. 6 (port of
``repro.core.hybrid_decoder``: the single-stream decode-execute, full
frame or ROI-gated).

Pipeline ①: decoded HD anchors -> DNN inference
Pipeline ②: LR frame -> quality transfer from anchors -> DNN inference
Pipeline ③: no decode, cached detections shifted by mean MV (reuse)

Latency model (paper Fig. 13b): transmission = bits / allocated bandwidth,
queueing from the serving queues, compute from per-pipeline costs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.codec.rate_model import upscale_nearest
from repro_torch.core.quality_transfer import (residual_to_pixels,
                                               transfer_frame)
from repro_torch.core.reuse import reuse_chunk
from repro_torch.core.roi import roi_detect
from repro_torch.codec.video_codec import EncodedChunk
from repro_torch.device import resolve_device
from repro_torch.models import detection as D

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PipelineCosts:
    """Per-frame edge compute costs (seconds), calibrated to the paper's
    RTX-3070 numbers: full inference ~33 ms, transfer+infer ~43 ms, reuse
    ~6 ms.  Used by the latency model."""
    infer: float = 0.033
    transfer: float = 0.010     # on top of infer for pipeline ②
    reuse: float = 0.006
    decode_hd: float = 0.004
    decode_video: float = 0.002


def pipeline_cost(n1, n2, n3, costs: PipelineCosts = PipelineCosts()):
    """Per-chunk edge compute time for n1/n2/n3 frames on pipelines ①/②/③."""
    return (n1 * (costs.infer + costs.decode_hd)
            + n2 * (costs.infer + costs.transfer + costs.decode_video)
            + n3 * costs.reuse)


def anchor_index(types):
    """For each frame i, the largest j <= i with types[j] == 1 (frame 0 if
    none): a cumulative max over the marked indices."""
    idx = torch.arange(types.shape[0], dtype=torch.int32, device=types.device)
    marked = torch.where(types == 1, idx, -1)
    return torch.cummax(marked, dim=0).values.clamp(min=0)


def _detect(detector_params, det_cfg, frames):
    raw = D.forward(detector_params, det_cfg, frames)
    return D.decode_boxes(raw, det_cfg)


def _residual_px(enc: EncodedChunk):
    """(T, h, w) decoded residuals of every frame, one blockdct inverse."""
    h, w = enc.recon.shape[1:]
    return residual_to_pixels(enc.residual_q, enc.qtab, h, w)


def _upscale_mvs(mv, hw):
    """LR MVs -> HD block grid + magnitude rescale (Fig. 7 step 2)."""
    H, W = hw
    nby, nbx = H // 16, W // 16
    T, nby_lr, nbx_lr, _ = mv.shape
    dev = mv.device
    yi = (torch.arange(nby, device=dev) * nby_lr // nby).clamp(0, nby_lr - 1)
    xi = (torch.arange(nbx, device=dev) * nbx_lr // nbx).clamp(0, nbx_lr - 1)
    mvu = mv[:, yi][:, :, xi].to(f32)
    # the scale factors rounded to f32, as the reference computes them
    sy = float(np.float32(H) / (np.float32(nby_lr) * np.float32(16.0)))
    sx = float(np.float32(W) / (np.float32(nbx_lr) * np.float32(16.0)))
    scaled = torch.stack([mvu[..., 0] * sy, mvu[..., 1] * sx], dim=-1)
    return torch.round(scaled).to(torch.int32)


def _transfer(anchor_plane, anchor_idx, mvs_hd, residual_up, frames, types):
    """Pipeline ② for every frame of the chunk in one qtransfer launch,
    kept where types == 2."""
    cum = torch.cumsum(mvs_hd, dim=0, dtype=torch.int32)
    mv_rel = cum - cum[anchor_idx.long()]
    enhanced = transfer_frame(anchor_plane, mv_rel, residual_up)
    return torch.where((types == 2)[:, None, None], enhanced, frames)


def _execute_chunk(enc: EncodedChunk, types, anchor_hd, gt_boxes, gt_valid,
                   detector_params, det_cfg, bw_kbps, queue_delay, total_bits,
                   costs: PipelineCosts, roi=None):
    """Upscale, quality transfer, one detector forward over the chunk
    (ROI-gated onto the top-K regions when ``roi`` is a
    :class:`~repro_torch.core.roi.RoiConfig`), reuse, F1 and the latency
    model."""
    H, W = anchor_hd.shape[1:]
    lr_up = upscale_nearest(enc.recon, H, W)
    aidx = anchor_index(types)
    anchor_plane = anchor_hd[aidx.long()]
    mvs_hd = _upscale_mvs(enc.mv, (H, W))
    residual_up = upscale_nearest(_residual_px(enc), H, W)
    frames_exec = torch.where((types == 1)[:, None, None], anchor_hd, lr_up)
    qt = _transfer(anchor_plane, aidx, mvs_hd, residual_up, frames_exec,
                   types)

    # pipelines ① + ② as one detector forward over the whole chunk
    if roi is not None:
        boxes_i, scores_i = roi_detect(
            detector_params, det_cfg, roi, qt, enc.mv, enc.residual_q,
            enc.recon.shape[1:])
    else:
        boxes_i, scores_i = _detect(detector_params, det_cfg, qt)
    boxes, scores = reuse_chunk(types, mvs_hd, boxes_i, scores_i)
    f1 = D.f1_score(boxes, scores, gt_boxes, gt_valid)

    n1 = (types == 1).sum().to(f32)
    n2 = (types == 2).sum().to(f32)
    n3 = (types == 3).sum().to(f32)
    t_comp = pipeline_cost(n1, n2, n3, costs)
    bw = torch.as_tensor(bw_kbps, dtype=f32, device=anchor_hd.device)
    t_trans = total_bits / (bw * 1000.0).clamp(min=1e-6)
    queue = torch.as_tensor(queue_delay, dtype=f32, device=anchor_hd.device)
    latency = t_trans + queue + t_comp
    return {"boxes": boxes, "scores": scores, "f1": f1,
            "mean_f1": f1.mean(), "latency": latency, "t_trans": t_trans,
            "t_queue": queue, "t_comp": t_comp}


def decode_execute_chunk(enc: EncodedChunk, types, anchor_hd, gt_boxes,
                         gt_valid, detector_params, det_cfg, *, bw_kbps,
                         queue_delay=0.0, total_bits=0.0,
                         costs: PipelineCosts = PipelineCosts(),
                         roi=None, device=None) -> dict:
    """One chunk of one stream through the 3 pipelines.

    enc: EncodedChunk; types: (T,) int; anchor_hd: (T, H, W);
    gt_boxes/gt_valid: (T, N, 4)/(T, N); roi: an optional
    :class:`~repro_torch.core.roi.RoiConfig` gate.  Every input is moved
    to the resolved device (CUDA unless ``device`` says otherwise).
    Returns a dict of tensors (boxes, scores, f1, mean_f1, latency,
    t_trans, t_queue, t_comp).
    """
    dev = resolve_device(device)
    enc = EncodedChunk(**{f.name: getattr(enc, f.name).to(dev)
                          for f in dataclasses.fields(enc)})
    params = {k: torch.as_tensor(v, device=dev)
              for k, v in detector_params.items()}
    return _execute_chunk(
        enc, torch.as_tensor(types, dtype=torch.int32, device=dev),
        torch.as_tensor(anchor_hd, dtype=f32, device=dev),
        torch.as_tensor(gt_boxes, dtype=f32, device=dev),
        torch.as_tensor(gt_valid, device=dev), params, det_cfg, bw_kbps,
        queue_delay, torch.as_tensor(total_bits, dtype=f32, device=dev),
        costs, roi=roi)
