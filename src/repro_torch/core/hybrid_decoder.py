"""Hybrid decoder + the 3 execution pipelines, paper §IV-B Fig. 6 (port of
``repro.core.hybrid_decoder``: the decode-execute of one stream or of S
streams at once, full frame or ROI-gated).

Pipeline ①: decoded HD anchors -> DNN inference
Pipeline ②: LR frame -> quality transfer from anchors -> DNN inference
Pipeline ③: no decode, cached detections shifted by mean MV (reuse)

Latency model (paper Fig. 13b): transmission = bits / allocated bandwidth,
queueing from the serving queues, compute from per-pipeline costs.

``_execute_chunk`` takes a leading stream axis on every input: the inverse
transform, the quality transfer and the detector forward each run once
over all S streams' frames, and the reuse loop is T steps for any S.
``lr_extent`` ((S, 2) valid LR extents) decodes a mixed-ladder padded
encode: the index maps then read only each stream's valid region, so a
lane equals the decode of its unpadded encode.

``decode_and_execute`` is the reference's legacy host-orchestrated path
for one :class:`~repro_torch.core.hybrid_encoder.HybridPacket` (the
nearest-anchor loop and the latency model on the host), kept as the
oracle of the fused path; ``decode_and_execute_fused`` is
``decode_execute_chunk`` behind the same packet-in, :class:`ChunkResult`
out contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.codec.motion import accumulate_mv
from repro_torch.codec.rate_model import upscale_nearest
from repro_torch.core.quality_transfer import (residual_to_pixels,
                                               transfer_frame)
from repro_torch.core.reuse import reuse_chunk
from repro_torch.core.roi import roi_detect
from repro_torch.codec.video_codec import EncodedChunk
from repro_torch.device import host_to_device, resolve_device
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


@dataclasses.dataclass
class ChunkResult:
    boxes: np.ndarray           # (T, N, 4)
    scores: np.ndarray          # (T, N)
    types: np.ndarray           # (T,)
    f1: np.ndarray              # (T,) accuracy vs GT
    mean_f1: float
    latency: float              # end-to-end chunk latency (s)
    t_trans: float
    t_queue: float
    t_comp: float


def anchor_index(types):
    """For each frame i, the largest j <= i with types[..., j] == 1 (frame
    0 if none): a cumulative max over the marked indices, along the last
    axis."""
    idx = torch.arange(types.shape[-1], dtype=torch.int32,
                       device=types.device)
    marked = torch.where(types == 1, idx, -1)
    return torch.cummax(marked, dim=-1).values.clamp(min=0)


def _detect(detector_params, det_cfg, frames):
    """(..., H, W) frames -> (boxes (..., Nc, 4), scores (..., Nc)), one
    forward over every frame."""
    *lead, H, W = frames.shape
    raw = D.forward(detector_params, det_cfg, frames.reshape(-1, H, W))
    boxes, scores = D.decode_boxes(raw, det_cfg)
    return (boxes.reshape(*lead, *boxes.shape[1:]),
            scores.reshape(*lead, scores.shape[1]))


def _residual_px(enc: EncodedChunk):
    """(S, T, h, w) decoded residuals of every frame of every stream, one
    blockdct inverse at each stream's table."""
    h, w = enc.recon.shape[-2:]
    return residual_to_pixels(enc.residual_q, enc.qtab[:, None], h, w)


def _upscale_mvs(mv, hw, lr_hw=None):
    """LR MVs (..., T, nby, nbx, 2) -> the HD block grid, magnitudes
    rescaled (Fig. 7 step 2).  ``lr_hw`` is the valid LR extent, (h, w)
    or (S, 2) of them, one a stream of a leading stream axis, when ``mv``
    carries a padded canvas's macroblocks; the scale factors are f32
    divisions in either form, as the reference computes them."""
    H, W = hw
    nby, nbx = H // 16, W // 16
    nby_p, nbx_p = mv.shape[-3:-1]
    dev = mv.device
    if lr_hw is None:
        n_lr = host_to_device([[nby_p, nbx_p]], dev)
    else:
        n_lr = host_to_device(lr_hw, dev).long().reshape(-1, 2) // 16
    S = n_lr.shape[0]
    ny, nx = n_lr[:, 0:1], n_lr[:, 1:2]                   # (S, 1)
    yi = torch.minimum(torch.arange(nby, device=dev)[None] * ny // nby,
                       ny - 1)
    xi = torch.minimum(torch.arange(nbx, device=dev)[None] * nx // nbx,
                       nx - 1)
    lead = mv.shape[:-3]
    m = mv.reshape(S, -1, nby_p * nbx_p, 2)
    idx = (yi[:, :, None] * nbx_p + xi[:, None, :]).reshape(S, 1, -1, 1)
    mvu = m.gather(2, idx.expand(S, m.shape[1], -1, 2)).to(f32)
    scale = host_to_device([H, W], dev, f32) \
        / (n_lr.to(f32) * 16.0)                           # (S, 2)
    scaled = mvu * scale[:, None, None, :]
    return torch.round(scaled).to(torch.int32).reshape(*lead, nby, nbx, 2)


def _transfer(anchor_plane, anchor_idx, mvs_hd, residual_up, frames, types):
    """Pipeline ② for every frame of every stream in one qtransfer launch,
    kept where types == 2.  (S, T, ...) inputs."""
    S, T = types.shape
    cum = accumulate_mv(mvs_hd)
    ss = torch.arange(S, device=types.device)[:, None]
    mv_rel = cum - cum[ss, anchor_idx.long()]
    enhanced = transfer_frame(anchor_plane.flatten(0, 1),
                              mv_rel.flatten(0, 1), residual_up.flatten(0, 1))
    return torch.where((types == 2)[..., None, None],
                       enhanced.reshape(frames.shape), frames)


def _execute_chunk(enc: EncodedChunk, types, anchor_hd, gt_boxes, gt_valid,
                   detector_params, det_cfg, bw_kbps, queue_delay, total_bits,
                   costs: PipelineCosts, lr_extent=None, roi=None):
    """S streams at once, every input with a leading stream axis (enc's
    fields (S, T, ...), types (S, T), anchor_hd (S, T, H, W), the scalars
    (S,)): upscale, quality transfer, one detector forward over the S*T
    frames (ROI-gated onto the top-K regions when ``roi`` is a
    :class:`~repro_torch.core.roi.RoiConfig`), reuse, F1 and the latency
    model.  ``lr_extent``: (S, 2) valid LR extents of a padded encode."""
    S, T, H, W = anchor_hd.shape
    lr_up = upscale_nearest(enc.recon, H, W, src_hw=lr_extent)
    aidx = anchor_index(types)
    ss = torch.arange(S, device=types.device)[:, None]
    anchor_plane = anchor_hd[ss, aidx.long()]
    mvs_hd = _upscale_mvs(enc.mv, (H, W), lr_hw=lr_extent)
    residual_up = upscale_nearest(_residual_px(enc), H, W, src_hw=lr_extent)
    frames_exec = torch.where((types == 1)[..., None, None], anchor_hd, lr_up)
    qt = _transfer(anchor_plane, aidx, mvs_hd, residual_up, frames_exec,
                   types)

    # pipelines ① + ② as one detector forward over every stream's frames
    if roi is not None:
        boxes_i, scores_i = roi_detect(
            detector_params, det_cfg, roi, qt, enc.mv, enc.residual_q,
            enc.recon.shape[-2:], lr_extent=lr_extent)
    else:
        boxes_i, scores_i = _detect(detector_params, det_cfg, qt)
    boxes, scores = reuse_chunk(types, mvs_hd, boxes_i, scores_i)
    f1 = D.f1_score(boxes.flatten(0, 1), scores.flatten(0, 1),
                    gt_boxes.flatten(0, 1), gt_valid.flatten(0, 1)
                    ).reshape(S, T)

    n1 = (types == 1).sum(-1).to(f32)
    n2 = (types == 2).sum(-1).to(f32)
    n3 = (types == 3).sum(-1).to(f32)
    t_comp = pipeline_cost(n1, n2, n3, costs)
    t_trans = total_bits / (bw_kbps * 1000.0).clamp(min=1e-6)
    latency = t_trans + queue_delay + t_comp
    return {"boxes": boxes, "scores": scores, "f1": f1,
            "mean_f1": f1.mean(-1), "latency": latency, "t_trans": t_trans,
            "t_queue": queue_delay, "t_comp": t_comp}


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
    enc = EncodedChunk(**{f.name: torch.as_tensor(getattr(enc, f.name),
                                                  device=dev)[None]
                          for f in dataclasses.fields(enc)})
    types, anchor_hd, gt_boxes, gt_valid = (
        torch.as_tensor(x, device=dev)[None]
        for x in (types, anchor_hd, gt_boxes, gt_valid))
    out = decode_execute_batched(
        enc, types, anchor_hd, gt_boxes, gt_valid, detector_params, det_cfg,
        bw_kbps=bw_kbps, queue_delay=queue_delay, total_bits=total_bits,
        costs=costs, roi=roi, device=dev)
    return {k: v[0] for k, v in out.items()}


def decode_execute_batched(enc: EncodedChunk, types, anchor_hd, gt_boxes,
                           gt_valid, detector_params, det_cfg, *, bw_kbps,
                           queue_delay, total_bits,
                           costs: PipelineCosts = PipelineCosts(),
                           roi=None, device=None) -> dict:
    """S chunks of S streams through the 3 pipelines at once: every input
    has a leading stream axis (enc from ``encode_chunk_batched``, types
    (S, T), anchor_hd (S, T, H, W), the scalars (S,) or one for all).
    Each kernel launches once for all S streams.  Runs on CUDA unless
    ``device`` says otherwise; returns the dict of
    :func:`decode_execute_chunk` with a leading stream axis."""
    dev = resolve_device(device)
    enc = EncodedChunk(**{f.name: torch.as_tensor(getattr(enc, f.name),
                                                  device=dev)
                          for f in dataclasses.fields(enc)})
    types = torch.as_tensor(types, dtype=torch.int32, device=dev)
    S = types.shape[0]
    bw_kbps, queue_delay, total_bits = (
        torch.as_tensor(x, dtype=f32, device=dev).reshape(-1).expand(S)
        for x in (bw_kbps, queue_delay, total_bits))
    return _execute_chunk(
        enc, types, torch.as_tensor(anchor_hd, dtype=f32, device=dev),
        torch.as_tensor(gt_boxes, dtype=f32, device=dev),
        torch.as_tensor(gt_valid, device=dev),
        {k: torch.as_tensor(v, device=dev)
         for k, v in detector_params.items()},
        det_cfg, bw_kbps, queue_delay, total_bits, costs, roi=roi)


def decode_and_execute(packet, detector_params, det_cfg, gt_boxes, gt_valid,
                       *, bw_kbps: float, queue_delay: float = 0.0,
                       costs: PipelineCosts = PipelineCosts(),
                       fps: float = 30.0, device=None) -> ChunkResult:
    """The 3 pipelines for one chunk of one stream, orchestrated on the
    host: the nearest-anchor index from a loop over the packet's host
    types, the latency model in host floats.  The residuals take one
    blockdct inverse launch and the quality transfer one qtransfer launch
    for the chunk.  Runs on CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    enc = EncodedChunk(**{f.name: torch.as_tensor(getattr(packet.video,
                                                          f.name)).to(dev)
                          for f in dataclasses.fields(packet.video)})
    host_types = np.asarray(packet.types)
    T = host_types.shape[0]
    anchor_hd = torch.as_tensor(packet.anchor_hd, dtype=f32).to(dev)
    H, W = anchor_hd.shape[1:]
    types = host_to_device(host_types, dev, torch.int32)
    params = {k: torch.as_tensor(v).to(dev)
              for k, v in detector_params.items()}

    lr_up = upscale_nearest(enc.recon, H, W)
    anchor_idx = np.zeros(T, np.int64)
    last = 0
    for i in range(T):
        if host_types[i] == 1:
            last = i
        anchor_idx[i] = last
    aidx = host_to_device(anchor_idx, dev)
    mvs_hd = _upscale_mvs(enc.mv, (H, W))
    h, w = enc.recon.shape[-2:]
    residual_up = upscale_nearest(
        residual_to_pixels(enc.residual_q, enc.qtab, h, w), H, W)
    frames_exec = torch.where((types == 1)[:, None, None], anchor_hd, lr_up)
    qt = _transfer(anchor_hd[aidx][None], aidx[None], mvs_hd[None],
                   residual_up[None], frames_exec[None], types[None])[0]
    boxes_i, scores_i = _detect(params, det_cfg, qt)
    boxes, scores = reuse_chunk(types, mvs_hd, boxes_i, scores_i)
    f1 = D.f1_score(boxes, scores,
                    torch.as_tensor(gt_boxes, dtype=f32).to(dev),
                    torch.as_tensor(gt_valid).to(dev)).cpu().numpy()

    n1, n2, n3 = (int((host_types == k).sum()) for k in (1, 2, 3))
    t_comp = pipeline_cost(n1, n2, n3, costs)
    t_trans = packet.total_bits / max(bw_kbps * 1000.0, 1e-6)
    latency = t_trans + queue_delay + t_comp
    return ChunkResult(boxes=boxes.cpu().numpy(),
                       scores=scores.cpu().numpy(), types=packet.types,
                       f1=f1, mean_f1=float(f1.mean(dtype=np.float32)),
                       latency=float(latency), t_trans=float(t_trans),
                       t_queue=float(queue_delay), t_comp=float(t_comp))


def decode_and_execute_fused(packet, detector_params, det_cfg, gt_boxes,
                             gt_valid, *, bw_kbps: float,
                             queue_delay: float = 0.0,
                             costs: PipelineCosts = PipelineCosts(),
                             device=None) -> ChunkResult:
    """``decode_execute_chunk`` with the packet-in, :class:`ChunkResult`
    out contract of :func:`decode_and_execute`."""
    out = decode_execute_chunk(
        packet.video, packet.types, packet.anchor_hd, gt_boxes, gt_valid,
        detector_params, det_cfg, bw_kbps=bw_kbps, queue_delay=queue_delay,
        total_bits=packet.total_bits, costs=costs, device=device)
    host = {k: v.cpu().numpy() for k, v in out.items()}
    return ChunkResult(boxes=host["boxes"], scores=host["scores"],
                       types=packet.types, f1=host["f1"],
                       mean_f1=float(host["mean_f1"]),
                       latency=float(host["latency"]),
                       t_trans=float(host["t_trans"]),
                       t_queue=float(host["t_queue"]),
                       t_comp=float(host["t_comp"]))
