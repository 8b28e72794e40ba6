"""Plain reference of the edge side: Eq. 3's frame types, the JPEG anchors
(pinned or by the budget search), the upscale, the quality transfer, the
TinyDetector (full frame or ROI-gated), the reuse of pipeline 3 and F1
(the semantics of ``repro.core`` and ``repro.models.detection``).

Plain PyTorch and numpy; no kernel, no code of the program.  The
convolutions run in float32 with TF32 off unless ``tf32`` says otherwise
(the control's step below float32).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from reference import codec as C

f32 = torch.float32
MB = 16
ANCHOR_LADDER = (20.0, 35.0, 50.0, 65.0, 80.0, 92.0)


def classify(frame_diff, residual_mag, tr1: float, tr2: float):
    """(S, T) features -> (S, T) int32 types: 1 when the accumulated
    frame difference passes tr1 (and frame 0), else 2 when the
    accumulated residual passes tr2, else 3; both reset at a type 1 or 2
    frame.  In float32 on the host."""
    fd = frame_diff.detach().to("cpu", f32).numpy()
    rm = residual_mag.detach().to("cpu", f32).numpy()
    lead, T = fd.shape[:-1], fd.shape[-1]
    t1 = np.broadcast_to(np.float32(tr1), lead).astype(np.float32)
    t2 = np.broadcast_to(np.float32(tr2), lead).astype(np.float32)
    types = np.zeros(fd.shape, np.int32)
    acc_x = np.zeros(lead, np.float32)
    acc_r = np.zeros(lead, np.float32)
    for i in range(T):
        x = acc_x + fd[..., i]
        r = acc_r + rm[..., i]
        is1 = (x > t1) | (i == 0)
        is2 = ~is1 & (r > t2)
        types[..., i] = np.where(is1, 1, np.where(is2, 2, 3))
        inferred = types[..., i] != 3
        acc_x = np.where(inferred, np.float32(0.0), x)
        acc_r = np.where(inferred, np.float32(0.0), r)
    return torch.from_numpy(types).to(frame_diff.device)


def anchors(raw, types, video_bits, bw_kbps, fps: float, pinned_q,
            search: bool):
    """The type-1 frames' JPEG anchors of (S, T, H, W) ``raw``: (anchor_hd,
    anchor_bits (S,), anchor_q (S, T)).  With the search, each frame's
    quality is the highest rung of ANCHOR_LADDER whose bits fit its even
    share of the chunk's spare bandwidth."""
    S, T, H, W = raw.shape
    dev = raw.device
    is1 = types == 1
    if search:
        bits = torch.stack([C.jpeg(raw, q)[1] for q in ANCHOR_LADDER], -1)
        n_anchors = C.seq_sum(torch.where(is1, 1.0, 0.0), 1)
        chunk_bits = torch.as_tensor(bw_kbps, dtype=f32, device=dev) \
            * 1000.0 * (T / fps)
        spare = (chunk_bits - video_bits).clamp(min=0.0)
        budget = spare / n_anchors.clamp(min=1.0)
        qs = torch.tensor(ANCHOR_LADDER, dtype=f32, device=dev)
        ok = bits <= budget[:, None, None]
        rung = torch.where(ok.any(-1),
                           torch.argmax(torch.where(ok, qs, -1.0), dim=-1), 0)
        tables = C.quant_table(ANCHOR_LADDER, dev)[rung]
        _, rec = C.dct_quantize(raw - 128.0, tables)
        rec = (rec + 128.0).clamp(0.0, 255.0)
        jbits = bits.gather(-1, rung[..., None])[..., 0]
        frame_q = qs[rung]
    else:
        rec, jbits = C.jpeg(raw, pinned_q)
        frame_q = torch.full((S, T), pinned_q, dtype=f32, device=dev)
    anchor_hd = torch.where(is1[..., None, None], rec, 0.0)
    anchor_bits = C.seq_sum(torch.where(is1, jbits, 0.0), 1)
    return anchor_hd, anchor_bits, torch.where(is1, frame_q, 0.0)


def upscale(frames, H: int, W: int, src_hw=None):
    """(S, n, h, w) -> (S, n, H, W) nearest neighbour by index map, over
    each stream's valid (h, w) when ``src_hw`` ((S, 2)) is given."""
    dev = frames.device
    hc, wc = frames.shape[-2:]
    ext = (torch.tensor([[hc, wc]], device=dev) if src_hw is None
           else src_hw.to(dev)).long().reshape(-1, 2)
    S = ext.shape[0]
    h, w = ext[:, 0:1], ext[:, 1:2]
    yi = torch.minimum(torch.arange(H, device=dev)[None] * h // H, h - 1)
    xi = torch.minimum(torch.arange(W, device=dev)[None] * w // W, w - 1)
    x = frames.reshape(S, -1, hc * wc)
    idx = (yi[:, :, None] * wc + xi[:, None, :]).reshape(S, 1, H * W)
    return x.gather(2, idx.expand(S, x.shape[1], H * W)).reshape(
        *frames.shape[:-2], H, W)


def upscale_mvs(mv, H: int, W: int, lr_hw=None):
    """LR vectors (S, T, nby, nbx, 2) -> the HD macroblock grid, each
    scaled by the f32 ratio of the HD to the valid LR extent, rounded."""
    nby, nbx = H // MB, W // MB
    nby_p, nbx_p = mv.shape[-3:-1]
    dev = mv.device
    n_lr = (torch.tensor([[nby_p, nbx_p]], device=dev) if lr_hw is None
            else lr_hw.to(dev).long().reshape(-1, 2) // MB)
    S = n_lr.shape[0]
    ny, nx = n_lr[:, 0:1], n_lr[:, 1:2]
    yi = torch.minimum(torch.arange(nby, device=dev)[None] * ny // nby,
                       ny - 1)
    xi = torch.minimum(torch.arange(nbx, device=dev)[None] * nx // nbx,
                       nx - 1)
    lead = mv.shape[:-3]
    m = mv.reshape(S, -1, nby_p * nbx_p, 2)
    idx = (yi[:, :, None] * nbx_p + xi[:, None, :]).reshape(S, 1, -1, 1)
    mvu = m.gather(2, idx.expand(S, m.shape[1], -1, 2)).to(f32)
    scale = torch.tensor([H, W], dtype=f32, device=dev) \
        / (n_lr.to(f32) * 16.0)
    return torch.round(mvu * scale[:, None, None, :]).to(torch.int32) \
        .reshape(*lead, nby, nbx, 2)


# ------------------------------------------------------------ the detector
@contextlib.contextmanager
def convolutions(tf32: bool):
    """cuDNN's float32 convolutions with TF32 as stated, restored after."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


def layer_strides(det: dict) -> tuple:
    n_down = {2: 1, 4: 2, 8: 3}[det["stride"]]
    return tuple(2 if i < n_down else 1 for i in range(len(det["channels"])))


def _same(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_layer(x, w, b, stride: int):
    """A 3x3 convolution with "SAME" zero padding at ``stride``, + bias,
    ReLU, on NCHW input."""
    ph = _same(x.shape[2], w.shape[2], stride)
    pw = _same(x.shape[3], w.shape[3], stride)
    return F.relu(F.conv2d(F.pad(x, (*pw, *ph)), w, b, stride=stride))


def detector(weights, det: dict, frames):
    """(B, H, W) [0..255] -> (B, H/s, W/s, 5) raw head outputs."""
    x = (frames.to(f32) / 255.0 - 0.5)[:, None]
    for i, stride in enumerate(layer_strides(det)):
        x = conv_layer(x, weights[f"conv{i}"], weights[f"bias{i}"], stride)
    return F.conv2d(x, weights["head"], weights["head_b"]).permute(0, 2, 3, 1)


def decode_boxes(raw, s: int):
    """-> (boxes (B, cells, 4) cxcywh px, scores (B, cells))."""
    B, hc, wc, _ = raw.shape
    dev = raw.device
    obj = torch.sigmoid(raw[..., 0])
    cy = (torch.arange(hc, dtype=f32, device=dev)[None, :, None] + 0.5
          + torch.tanh(raw[..., 1])) * s
    cx = (torch.arange(wc, dtype=f32, device=dev)[None, None, :] + 0.5
          + torch.tanh(raw[..., 2])) * s
    h = torch.exp(raw[..., 3].clamp(-3, 3)) * s
    w = torch.exp(raw[..., 4].clamp(-3, 3)) * s
    return (torch.stack([cy, cx, h, w], dim=-1).reshape(B, -1, 4),
            obj.reshape(B, -1))


@torch.no_grad()
def hd_detections(weights, det: dict, raw, n: int, frames_a_block: int = 30):
    """(S, T, H, W) HD frames -> (boxes (S, T, n, 4), valid (S, T, n)):
    each frame's ``n`` highest-scoring cells of the detector (ties to the
    lower cell) in float32 with TF32 off, valid where the score passes
    0.5."""
    S, T, H, W = raw.shape
    flat = raw.reshape(S * T, H, W)
    boxes, valid = [], []
    with convolutions(tf32=False):
        for a in range(0, S * T, frames_a_block):
            b, s = decode_boxes(detector(weights, det,
                                         flat[a:a + frames_a_block]),
                                det["stride"])
            sc, idx = torch.sort(s, dim=-1, descending=True, stable=True)
            sc, idx = sc[:, :n], idx[:, :n]
            boxes.append(b.gather(1, idx[..., None].expand(*idx.shape, 4)))
            valid.append(sc > 0.5)
    return (torch.cat(boxes).reshape(S, T, n, 4),
            torch.cat(valid).reshape(S, T, n))


# ------------------------------------------------------------ the ROI gate
def region_scores(mv, residual_q, lr_hw, H: int, W: int, roi: dict,
                  lr_extent=None):
    """(S, T, nry, nrx) relevance of each HD region: the max over its 8-px
    samples of w_motion (|dy| + |dx| of the nearest LR macroblock) + w_resid
    (mean |coef| of the nearest LR 8x8 block)."""
    h, w = lr_hw
    rp = roi["region_px"]
    nry, nrx = H // rp, W // rp
    s = rp // 8
    dev = mv.device
    ext = (torch.tensor([[h, w]], device=dev) if lr_extent is None
           else lr_extent.to(dev)).long().reshape(-1, 2)
    hv, wv = ext[:, 0:1], ext[:, 1:2]
    S = ext.shape[0]
    lead = mv.shape[:-3]
    ys = torch.arange(nry * s, device=dev)[None] * 8 + 4
    xs = torch.arange(nrx * s, device=dev)[None] * 8 + 4
    ylr = torch.minimum(ys * hv // H, hv - 1)
    xlr = torch.minimum(xs * wv // W, wv - 1)
    mby = torch.minimum(ylr // 16, (hv // 16 - 1).clamp(min=0))
    mbx = torch.minimum(xlr // 16, (wv // 16 - 1).clamp(min=0))
    rby = torch.minimum(ylr // 8, hv // 8 - 1)
    rbx = torch.minimum(xlr // 8, wv // 8 - 1)

    def sample(values, idx):
        v = values.reshape(S, -1, values.shape[-1])
        i = idx.reshape(S, 1, -1).expand(S, v.shape[1], -1)
        return v.gather(2, i).reshape(*lead, *idx.shape[1:])

    nbx = mv.shape[-2]
    motion = mv.to(f32).abs().sum(-1).flatten(-2)
    motion_s = sample(motion, mby[:, :, None] * nbx + mbx[:, None, :])
    energy = residual_q.to(f32).abs().mean((-1, -2))
    energy_s = sample(energy, rby[:, :, None] * (w // 8) + rbx[:, None, :])
    samples = roi["w_motion"] * motion_s + roi["w_resid"] * energy_s
    return samples.reshape(*lead, nry, s, nrx, s).amax(dim=(-3, -1))


def roi_select(scores, capacity: int, threshold: float):
    """The top ``capacity`` regions scoring >= threshold, descending, the
    lower index first on ties: (idx (..., K), valid (..., K))."""
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
    return torch.where(valid, idx, 0), valid


def roi_maps(weights, det: dict, roi: dict, frames, idx, valid):
    """Each selected region's patch (region + halo, zero outside the
    frame) through the detector, its interior scattered into the frame's
    map; a region the gate skips keeps the output of the last frame of its
    stream that selected it (0 if none): (S, T, H/s, W/s, 5)."""
    S, T, H, W = frames.shape
    rp, halo = roi["region_px"], roi["halo"]
    nry, nrx = H // rp, W // rp
    R = nry * nrx
    st_ = det["stride"]
    rc = rp // st_
    dev = frames.device
    K = idx.shape[-1]
    flat = idx.reshape(-1, K).long()
    ry, rx = flat // nrx, flat % nrx
    P = rp + 2 * halo
    xp = F.pad((frames.reshape(-1, H, W).to(f32) / 255.0 - 0.5),
               (halo,) * 4)
    wins = xp.unfold(1, P, 1).unfold(2, P, 1)
    t = torch.arange(xp.shape[0], device=dev)[:, None]
    patches = wins[t, ry * rp, rx * rp]                  # (S*T, K, P, P)
    x = patches.reshape(-1, 1, P, P)
    ri, rj = ry.reshape(-1, 1), rx.reshape(-1, 1)
    halo_l, reg_l, Hl, Wl = halo, rp, H, W
    for i, stride in enumerate(layer_strides(det)):
        x = conv_layer(x, weights[f"conv{i}"], weights[f"bias{i}"], stride)
        halo_l //= stride
        reg_l //= stride
        Hl //= stride
        Wl //= stride
        ar = torch.arange(x.shape[2], device=dev)[None, :]
        gy = ri * reg_l - halo_l + ar
        gx = rj * reg_l - halo_l + ar
        m = ((gy >= 0) & (gy < Hl))[:, :, None] \
            & ((gx >= 0) & (gx < Wl))[:, None, :]
        x = torch.where(m[:, None], x, 0.0)
    x = F.conv2d(x, weights["head"], weights["head_b"])
    x = x[:, :, halo_l:halo_l + reg_l, halo_l:halo_l + reg_l]
    raws = x.permute(0, 2, 3, 1).reshape(S, T, K, rc, rc, -1)
    idx3 = idx.reshape(S, T, K).long()
    lane = torch.full((S, T, R + 1), -1, dtype=torch.long, device=dev)
    lane.scatter_(2, torch.where(valid.reshape(S, T, K), idx3, R),
                  torch.arange(K, device=dev).expand(S, T, K))
    lane = lane[..., :R]
    src_t = torch.where(lane >= 0, torch.arange(T, device=dev)[None, :, None],
                        -1)
    src_t = torch.cummax(src_t, dim=1).values
    st = src_t.clamp(min=0)
    ss = torch.arange(S, device=dev)[:, None, None]
    sk = lane[ss, st, torch.arange(R, device=dev)].clamp(min=0)
    regions = torch.where((src_t >= 0)[..., None, None, None],
                          raws[ss, st, sk], 0.0)
    return regions.reshape(S, T, nry, nrx, rc, rc, -1).permute(
        0, 1, 2, 4, 3, 5, 6).reshape(S, T, nry * rc, nrx * rc, -1)


# ---------------------------------------------------------- reuse and F1
def shift_boxes(boxes, mv):
    """Each box moved by minus the mean vector of the macroblocks it
    covers (pred(y) = ref(y + mv))."""
    nby, nbx = mv.shape[-3:-1]
    dev = boxes.device
    cy = (torch.arange(nby, dtype=f32, device=dev) + 0.5) * MB
    cx = (torch.arange(nbx, dtype=f32, device=dev) + 0.5) * MB
    in_y = ((cy - boxes[..., 0:1]).abs()
            <= boxes[..., 2:3] / 2 + MB / 2).to(f32)
    in_x = ((cx - boxes[..., 1:2]).abs()
            <= boxes[..., 3:4] / 2 + MB / 2).to(f32)
    m = mv.to(f32)
    n = (in_y.sum(-1) * in_x.sum(-1)).clamp(min=1e-9)
    dy = ((in_y @ m[..., 0]) * in_x).sum(-1) / n
    dx = ((in_y @ m[..., 1]) * in_x).sum(-1) / n
    zero = torch.zeros_like(dy)
    return boxes - torch.stack([dy, dx, zero, zero], dim=-1)


def reuse(types, mvs, boxes_i, scores_i):
    """Pipeline 3: a type-3 frame carries the previous frame's detections
    shifted by its vectors; other frames keep their own."""
    T = types.shape[-1]
    boxes, scores = boxes_i[..., 0, :, :], scores_i[..., 0, :]
    out_b, out_s = [], []
    for i in range(T):
        fresh = (types[..., i] != 3)[..., None]
        shifted = shift_boxes(boxes, mvs[..., i, :, :, :])
        boxes = torch.where(fresh[..., None], boxes_i[..., i, :, :], shifted)
        scores = torch.where(fresh, scores_i[..., i, :], scores)
        out_b.append(boxes)
        out_s.append(scores)
    return torch.stack(out_b, dim=-3), torch.stack(out_s, dim=-2)


def iou(a, b):
    ay0, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ax0, ax1 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    by0, by1 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    bx0, bx1 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iy = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp(min=0)
    ix = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp(min=0)
    inter = iy * ix
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / union.clamp(min=1e-9)


def f1(pred_boxes, pred_scores, gt_boxes, gt_valid, iou_thresh: float = 0.5,
       score_thresh: float = 0.5):
    """Greedy-matching F1 at IoU 0.5 a frame: min(P, G) rounds, each
    taking the highest remaining IoU (the first on ties), a hit when it
    reaches the threshold, then clearing that prediction and that box."""
    conf = pred_scores > score_thresh
    valid = gt_valid.to(f32)
    m = iou(pred_boxes[:, :, None], gt_boxes[:, None])
    m = m * conf[:, :, None] * valid[:, None, :]
    B, P, G = m.shape
    rows = torch.arange(B, device=m.device)
    tp = torch.zeros(B, dtype=f32, device=m.device)
    for _ in range(min(P, G)):
        flat = m.reshape(B, -1).argmax(dim=1)
        pi, gi = flat // G, flat % G
        hit = m[rows, pi, gi] >= iou_thresh
        keep_row = torch.arange(P, device=m.device)[None] != pi[:, None]
        keep_col = torch.arange(G, device=m.device)[None] != gi[:, None]
        cleared = m * keep_row[:, :, None] * keep_col[:, None, :]
        m = torch.where(hit[:, None, None], cleared, m)
        tp = tp + hit.to(f32)
    n_pred = conf.sum(1).to(f32)
    n_gt = valid.sum(1)
    prec = tp / n_pred.clamp(min=1e-9)
    rec = tp / n_gt.clamp(min=1e-9)
    out = 2 * prec * rec / (prec + rec).clamp(min=1e-9)
    return torch.where(n_gt > 0, out, torch.where(n_pred > 0, 0.0, 1.0))
