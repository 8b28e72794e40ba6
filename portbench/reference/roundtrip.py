"""The plain reference of one chunk of S streams through BiSwift's round
trip: the LR frames, the I/P encode, Eq. 3's types, the anchors, the
decode-execute of the three pipelines (full frame or ROI-gated), reuse and
F1.  It takes only what the benchmark made: the HD frames, the ground
truth, the detector's weights, each stream's rung and link, and the
configuration.

``precision="control"`` computes it one step below what the configuration
states: the motion search's planes stored one type lower (float32 ->
bfloat16 -> uint8) and the convolutions in TF32.
"""
from __future__ import annotations

import torch

from reference import codec as C
from reference import decode as D

f32 = torch.float32
LOWER = {"float32": "bfloat16", "bfloat16": "uint8"}


@torch.no_grad()
def roundtrip(raw, gt_boxes, gt_valid, weights, cfg: dict, rungs: list,
              bw_kbps: list, ladder, *, padded: bool,
              precision: str = "stated") -> dict:
    """raw (S, T, H, W) [0, 255] on the device to compute on; ``rungs``
    and ``bw_kbps`` one a stream; ``ladder`` the rungs' (bitrate, scale,
    quality); ``padded``: every stream encoded on the full LR canvas at
    its own rung (else all at ``rungs[0]`` on their own LR shape).
    Returns boxes (S, T, cells, 4), scores (S, T, cells), types, anchor_q
    (S, T), video_bits, anchor_bits (S,) and f1 (S, T)."""
    if precision not in ("stated", "control"):
        raise ValueError(f"unknown precision {precision!r}")
    control = precision == "control"
    codec, det, roi = cfg["codec"], cfg["detector"], cfg.get("roi")
    S, T, H, W = raw.shape
    dev = raw.device
    store = LOWER[codec["dtype"]] if control else codec["dtype"]
    lr = [C.downscale(raw[s], rungs[s], ladder) for s in range(S)]
    if padded:
        hp, wp = C.lr_shape(1.0, H, W)
        lr_in = torch.stack([torch.nn.functional.pad(
            x, (0, wp - x.shape[-1], 0, hp - x.shape[-2])) for x in lr])
        extent = torch.tensor([tuple(x.shape[-2:]) for x in lr],
                              dtype=torch.int32, device=dev)
        quality = [ladder[r][2] for r in rungs]
    else:
        lr_in, extent, quality = torch.stack(lr), None, ladder[rungs[0]][2]
    enc = C.encode(lr_in, quality, codec, extent=extent, search_store=store)
    del lr, lr_in

    video_bits = C.seq_sum(enc["bits"], 1)
    types = D.classify(enc["frame_diff"] / 255.0, enc["residual_mag"] / 255.0,
                       cfg["tr1"], cfg["tr2"])
    bw = torch.tensor(bw_kbps, dtype=f32, device=dev)
    anchor_hd, anchor_bits, anchor_q = D.anchors(
        raw, types, video_bits, bw, cfg["fps"], cfg["anchor_quality"],
        cfg["anchor_search"])

    lr_up = D.upscale(enc["recon"], H, W, src_hw=extent)
    marked = torch.where(types == 1, torch.arange(T, dtype=torch.int32,
                                                  device=dev), -1)
    aidx = torch.cummax(marked, dim=-1).values.clamp(min=0).long()
    ss = torch.arange(S, device=dev)[:, None]
    mvs_hd = D.upscale_mvs(enc["mv"], H, W, lr_hw=extent)
    h, w = enc["recon"].shape[-2:]
    resid = C.dequant_idct(enc["residual_q"], enc["qtab"][:, None], h, w)
    residual_up = D.upscale(resid, H, W, src_hw=extent)
    del resid
    frames = torch.where((types == 1)[..., None, None], anchor_hd, lr_up)
    del lr_up
    cum = torch.cumsum(mvs_hd, dim=1, dtype=torch.int32)
    mv_rel = cum - cum[ss, aidx]
    enhanced = C.warp(anchor_hd[ss, aidx].flatten(0, 1), mv_rel.flatten(0, 1),
                      residual_up.flatten(0, 1))
    del residual_up, anchor_hd
    frames = torch.where((types == 2)[..., None, None],
                         enhanced.reshape(frames.shape), frames)
    del enhanced

    with D.convolutions(tf32=control):
        if roi is not None:
            scores = D.region_scores(enc["mv"], enc["residual_q"], (h, w), H,
                                     W, roi, lr_extent=extent)
            idx, valid = D.roi_select(scores.reshape(S, T, -1),
                                      roi["capacity"], roi["threshold"])
            maps = D.roi_maps(weights, det, roi, frames, idx, valid)
            raw_out = maps.reshape(-1, *maps.shape[-3:])
        else:
            raw_out = D.detector(weights, det, frames.reshape(-1, H, W))
    boxes_i, scores_i = D.decode_boxes(raw_out, det["stride"])
    boxes_i = boxes_i.reshape(S, T, *boxes_i.shape[1:])
    scores_i = scores_i.reshape(S, T, -1)
    boxes, scores = D.reuse(types, mvs_hd, boxes_i, scores_i)
    f1 = D.f1(boxes.flatten(0, 1), scores.flatten(0, 1),
              gt_boxes.flatten(0, 1), gt_valid.flatten(0, 1)).reshape(S, T)
    return dict(boxes=boxes, scores=scores, types=types, anchor_q=anchor_q,
                video_bits=video_bits, anchor_bits=anchor_bits, f1=f1)
