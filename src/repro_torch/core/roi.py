"""ROI-gated detector inference (port of ``repro.core.roi``).

A relevance head over statistics the codec already computed (macroblock
motion vectors and quantised residual energy) scores each
``region_px``-sided HD region; the top K regions of each frame are packed
into a fixed-capacity batch of halo-padded patches (the ``roi_gather``
kernel on CUDA); the detector's convolutions run on the patches only;
and each region's raw head output is scattered back into the frame's map.
With ``carry=True`` a region the gate skips keeps its last computed raw
output (region-granular reuse); a region never selected stays at 0.

When the gate admits every region the assembled map equals the
full-frame ``detection.forward``: each patch carries a halo of at least
the convolutions' receptive field, the planes are normalised before they
are padded with zeros, and after every layer the activations that fall
outside the frame are zeroed, which is the full frame's "SAME" padding.

Every entry takes a leading stream axis: S streams' frames go through one
gather and one patch forward, and the carry runs along each stream's
frames.  ``lr_extent`` gives each stream's valid LR extent when the codec
statistics come from a mixed-ladder padded encode.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import host_to_device
from repro_torch.kernels.roi_gather.ops import roi_gather
from repro_torch.models import detection as D

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RoiConfig:
    """The reference's gate config without ``use_kernel``: on CUDA the
    patch gather always launches the ``roi_gather`` kernel, as the codec's
    search always launches ``motion_sad``.

    ``region_px``: HD region side (divides H and W; a multiple of 8 and of
    the detector stride); ``halo``: context margin per patch side (at
    least the receptive field, a multiple of the stride); ``capacity``: K
    patch lanes per frame; ``threshold``: least score a region needs
    (``<= 0`` admits every region to the top-K); ``w_motion``/``w_resid``:
    the relevance head's weights."""
    region_px: int = 32
    halo: int = 8
    capacity: int = 8
    threshold: float = 0.0
    w_motion: float = 1.0
    w_resid: float = 1.0


def region_grid(hd_hw, roi: RoiConfig) -> tuple[int, int]:
    """(n_region_rows, n_region_cols) of the HD region grid."""
    H, W = hd_hw
    if H % roi.region_px or W % roi.region_px:
        raise ValueError(
            f"RoiConfig.region_px={roi.region_px} must divide the HD "
            f"shape ({H}, {W})")
    return H // roi.region_px, W // roi.region_px


def required_halo(det_cfg) -> int:
    """Receptive-field radius of the conv stack at input resolution: a
    3x3 layer adds +-1 at its input's scale, and each downsampling layer
    doubles the scale of every layer after it."""
    rf, grow = 0, 1
    for stride in D.layer_strides(det_cfg):
        rf += grow
        grow *= stride
    return rf


def validate_roi(roi: RoiConfig, det_cfg, hd_hw) -> None:
    """Raises ValueError on a (roi, detector, HD shape) binding the patch
    forward cannot reproduce the full frame on."""
    region_grid(hd_hw, roi)
    s = det_cfg.stride
    if roi.region_px % 8 or roi.region_px % s:
        raise ValueError(
            f"region_px={roi.region_px} must be a multiple of 8 and of "
            f"the detector stride {s}")
    if roi.halo % s:
        raise ValueError(
            f"halo={roi.halo} must be a multiple of the total "
            f"downsampling {s} (the interior crop happens on the "
            "stride-s output grid)")
    rf = required_halo(det_cfg)
    if roi.halo < rf:
        raise ValueError(
            f"halo={roi.halo} is smaller than the detector's receptive "
            f"field radius {rf}; patch outputs would diverge from the "
            "full-frame forward")
    if roi.capacity < 1:
        raise ValueError(f"capacity={roi.capacity} must be >= 1")


# ---------------------------------------------------------- relevance head
def region_scores(mv, residual_q, lr_hw, hd_hw, roi: RoiConfig,
                  lr_extent=None):
    """(..., T, nry, nrx) f32 relevance scores.

    ``mv``: (..., T, nby, nbx, 2) LR macroblock motion vectors;
    ``residual_q``: (..., T, nblocks, 8, 8) quantised residual coefficients
    (row-major 8x8 blocks of the LR canvas); ``lr_hw``: the LR canvas
    shape; ``lr_extent``: the valid (h, w), or (S, 2) of them, one a
    stream of a leading stream axis, when the statistics come from the
    mixed-ladder padded encode (the samples then map onto the valid
    region only).  Each HD region is sampled on an 8-px sub-grid; a sample
    maps to its nearest LR macroblock (|dy| + |dx|) and nearest LR 8x8
    block (mean |coef|), and the region's score is the max over its
    samples of ``w_motion * motion + w_resid * residual``."""
    H, W = hd_hw
    h, w = lr_hw
    nry, nrx = region_grid((H, W), roi)
    s = roi.region_px // 8                  # samples per region side
    dev = mv.device
    ext = host_to_device((h, w) if lr_extent is None else lr_extent,
                         dev).long().reshape(-1, 2)
    hv, wv = ext[:, 0:1], ext[:, 1:2]                      # (S, 1)
    S = ext.shape[0]
    lead = mv.shape[:-3]
    ys = torch.arange(nry * s, device=dev)[None] * 8 + 4
    xs = torch.arange(nrx * s, device=dev)[None] * 8 + 4
    # the reference's clips; every index is >= 0 already
    ylr = torch.minimum(ys * hv // H, hv - 1)
    xlr = torch.minimum(xs * wv // W, wv - 1)
    mby = torch.minimum(ylr // 16, (hv // 16 - 1).clamp(min=0))
    mbx = torch.minimum(xlr // 16, (wv // 16 - 1).clamp(min=0))
    rby = torch.minimum(ylr // 8, hv // 8 - 1)
    rbx = torch.minimum(xlr // 8, wv // 8 - 1)

    def sample(values, idx):
        """values (..., n) gathered at each stream's (S, Ny, Nx) index."""
        v = values.reshape(S, -1, values.shape[-1])
        i = idx.reshape(S, 1, -1).expand(S, v.shape[1], -1)
        return v.gather(2, i).reshape(*lead, *idx.shape[1:])

    nbx = mv.shape[-2]
    motion = mv.to(f32).abs().sum(-1).flatten(-2)          # (..., nby*nbx)
    motion_s = sample(motion, mby[:, :, None] * nbx + mbx[:, None, :])
    energy = residual_q.to(f32).abs().mean((-1, -2))       # (..., nblocks)
    energy_s = sample(energy, rby[:, :, None] * (w // 8) + rbx[:, None, :])
    samples = roi.w_motion * motion_s + roi.w_resid * energy_s
    return samples.reshape(*lead, nry, s, nrx, s).amax(dim=(-3, -1))


def roi_select(scores, capacity: int, threshold: float):
    """The top ``capacity`` regions with score >= threshold, descending,
    ties broken by the lower flat index (``lax.top_k``'s order, here a
    stable descending sort).  scores (..., R) -> (idx (..., K) int32,
    valid (..., K) bool); lanes beyond the admitted regions are
    ``valid=False`` with index 0."""
    R = scores.shape[-1]
    keyed = torch.where(scores >= threshold, scores.to(f32), -torch.inf)
    k = min(capacity, R)
    top, idx = torch.sort(keyed, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    valid = torch.isfinite(top)
    if k < capacity:
        pad = (*idx.shape[:-1], capacity - k)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=-1)
    return torch.where(valid, idx, 0).to(torch.int32), valid


# ------------------------------------------ packed patches: gather, forward
def extract_patches(frames, ry, rx, roi: RoiConfig):
    """(T, H, W) [0..255] frames and (T, K) region coordinates -> (T, K,
    P, P) normalised patches, P = region_px + 2*halo.  The frames are
    normalised before the zero halo is added, so that the margin equals
    the convolutions' zero padding."""
    xn = frames.to(f32) / 255.0 - 0.5
    xp = F.pad(xn, (roi.halo,) * 4)
    return roi_gather(xp.contiguous(), ry.to(torch.int32).contiguous(),
                      rx.to(torch.int32).contiguous(),
                      region_px=roi.region_px, halo=roi.halo)


def forward_patches(params, det_cfg, patches, ry, rx, hd_hw,
                    roi: RoiConfig):
    """Detector forward over the packed batch, all T*K patches at once ->
    (T, K, rc, rc, 5), rc = region_px / stride.  After every conv layer
    (conv, + bias, ReLU) the activations whose global coordinate lies
    outside the frame are zeroed; the halo and the region shrink by each
    layer's stride."""
    H, W = hd_hw
    T, K, P, _ = patches.shape
    x = patches.reshape(T * K, 1, P, P)
    ri = ry.reshape(-1, 1).long()
    rj = rx.reshape(-1, 1).long()
    halo_l, reg_l, Hl, Wl = roi.halo, roi.region_px, H, W
    for i, stride in enumerate(D.layer_strides(det_cfg)):
        x = D.conv_layer(x, params[f"conv{i}"], params[f"bias{i}"], stride)
        halo_l //= stride
        reg_l //= stride
        Hl //= stride
        Wl //= stride
        ar = torch.arange(x.shape[2], device=x.device)[None, :]
        gy = ri * reg_l - halo_l + ar                        # (TK, P_l)
        gx = rj * reg_l - halo_l + ar
        m = ((gy >= 0) & (gy < Hl))[:, :, None] \
            & ((gx >= 0) & (gx < Wl))[:, None, :]
        x = torch.where(m[:, None], x, 0.0)
    x = F.conv2d(x, params["head"], params["head_b"])
    x = x[:, :, halo_l:halo_l + reg_l, halo_l:halo_l + reg_l]
    return x.permute(0, 2, 3, 1).reshape(T, K, reg_l, reg_l, x.shape[1])


def roi_raw_maps(params, det_cfg, roi: RoiConfig, frames, idx, valid, *,
                 carry: bool = True):
    """Gather, forward and scatter: (..., T, H, W) frames and a (..., T, K)
    selection -> (..., T, H/s, W/s, 5) raw head maps; every stream's
    patches go through one gather and one forward.

    ``carry=True``: region r at frame t holds the raw output of the last
    frame <= t of its stream that selected it (the reference's ``lax.scan``
    carry), found with one ``cummax`` over a (S, T, R) mark and one
    gather; a region never selected holds 0.  ``carry=False``: each
    frame's map holds only its own selected regions.  Invalid lanes are
    dropped."""
    *lead, T, H, W = frames.shape
    validate_roi(roi, det_cfg, (H, W))
    nry, nrx = region_grid((H, W), roi)
    R = nry * nrx
    rc = roi.region_px // det_cfg.stride
    dev = frames.device
    K = idx.shape[-1]
    idx = idx.reshape(-1, T, K).long()
    valid = valid.reshape(-1, T, K)
    S = idx.shape[0]
    flat = idx.reshape(-1, K)
    patches = extract_patches(frames.reshape(-1, H, W), flat // nrx,
                              flat % nrx, roi)
    raws = forward_patches(params, det_cfg, patches, flat // nrx, flat % nrx,
                           (H, W), roi).reshape(S, T, K, rc, rc, -1)
    # lane[s, t, r]: the lane of frame t that computed region r, or -1;
    # invalid lanes go to the extra column R and are cut off
    lane = torch.full((S, T, R + 1), -1, dtype=torch.long, device=dev)
    lane.scatter_(2, torch.where(valid, idx, R),
                  torch.arange(K, device=dev).expand(S, T, K))
    lane = lane[..., :R]
    frame = torch.arange(T, device=dev)[None, :, None]
    src_t = torch.where(lane >= 0, frame, -1)
    if carry:
        src_t = torch.cummax(src_t, dim=1).values
    st = src_t.clamp(min=0)
    ss = torch.arange(S, device=dev)[:, None, None]
    sk = lane[ss, st, torch.arange(R, device=dev)].clamp(min=0)
    regions = torch.where((src_t >= 0)[..., None, None, None],
                          raws[ss, st, sk], 0.0)          # (S, T, R, rc, rc, 5)
    return regions.reshape(S, T, nry, nrx, rc, rc, -1).permute(
        0, 1, 2, 4, 3, 5, 6).reshape(*lead, T, nry * rc, nrx * rc, -1)


# ------------------------------------------------------------ entry points
def roi_detect(params, det_cfg, roi: RoiConfig, frames, mv, residual_q,
               lr_hw, lr_extent=None):
    """ROI-gated stand-in for the full-frame detector: score, select,
    gather, forward, scatter with the carry, decode.  frames (..., T, H,
    W) with the codec statistics of the same leading axes; ``lr_extent``
    as for :func:`region_scores`.  Returns (boxes, scores) shaped as
    ``detection.decode_boxes`` on the full frames, (..., T, Nc, 4) and
    (..., T, Nc)."""
    *lead, T, H, W = frames.shape
    nry, nrx = region_grid((H, W), roi)
    scores = region_scores(mv, residual_q, lr_hw, (H, W), roi,
                           lr_extent=lr_extent)
    idx, valid = roi_select(scores.reshape(*lead, T, nry * nrx),
                            roi.capacity, roi.threshold)
    maps = roi_raw_maps(params, det_cfg, roi, frames, idx, valid,
                        carry=True)
    boxes, obj = D.decode_boxes(maps.reshape(-1, *maps.shape[-3:]), det_cfg)
    return (boxes.reshape(*lead, T, *boxes.shape[1:]),
            obj.reshape(*lead, T, obj.shape[1]))


def roi_infer(params, det_cfg, roi: RoiConfig, frames, scores):
    """Batched form without the carry: each row of ``frames`` is gated by
    its own region scores ((T, R))."""
    idx, valid = roi_select(scores, roi.capacity, roi.threshold)
    maps = roi_raw_maps(params, det_cfg, roi, frames, idx, valid,
                        carry=False)
    return D.decode_boxes(maps, det_cfg)
