"""Operations and bytes a chunk needs, counted from shapes: the
benchmark's own count, so that no change to the program moves it.

Work is what the algorithm needs for the chunk's inputs, not what an
implementation happens to do: the detector on the frames of pipelines 1
and 2 only (or their ROI patches), the JPEG anchors of type-1 frames
only, the residual decode and the quality transfer of type-2 frames only,
the motion search over each stream's valid macroblocks.  Each input byte
is read once and each output byte written once.

Peaks: one H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s in float32
outside the tensor cores (what the detector's float32 convolutions with
TF32 off and the search use), 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import dataclasses

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
MB = 16
DCT_OPS_PX = 64          # forward and reconstruction: 4 products of 8 MACs
DCT_HALF_OPS_PX = 32     # the forward alone, or the inverse alone
ANCHOR_RUNGS = 6


def conv_ops(det: dict, H: int, W: int) -> float:
    """Multiply-adds (2 operations each) of the detector on one (H, W)
    input: 3x3 convolutions at their strides ("SAME"), then the 1x1
    head."""
    n_down = {2: 1, 4: 2, 8: 3}[det["stride"]]
    ops, cin, h, w = 0.0, 1, H, W
    for i, c in enumerate(det["channels"]):
        s = 2 if i < n_down else 1
        h, w = -(-h // s), -(-w // s)
        ops += 2.0 * c * cin * 9 * h * w
        cin = c
    return ops + 2.0 * 5 * cin * h * w


def lr_shape(scale: float, H: int, W: int) -> tuple[int, int]:
    return max(int(H * scale) // 16 * 16, 16), max(int(W * scale) // 16 * 16,
                                                   16)


@dataclasses.dataclass
class Work:
    """A chunk's work: operations and bytes of each kernel's task, and
    the operations of the whole step (detector, search, transforms)."""
    kernels: dict          # kernel -> [operations, bytes]
    step_ops: float

    def bound_s(self, kernel: str) -> float:
        ops, nbytes = self.kernels[kernel]
        return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def chunk_work(cfg: dict, scales: list, types_by_stream, H: int, W: int,
               T: int) -> Work:
    """``scales``: each stream's LR scale this chunk; ``types_by_stream``:
    (S, 3) frames of types 1, 2 and 3 of each stream."""
    codec, det, roi = cfg["codec"], cfg["detector"], cfg.get("roi")
    store = 2 if codec["dtype"] == "bfloat16" else 4
    R = codec["search_radius"]
    cand = (1 + 9 * len(_diamond_steps(R)) if codec["search"] == "diamond"
            else (2 * R + 1) ** 2)
    k = {n: [0.0, 0.0] for n in ("motion_sad", "blockdct", "qtransfer",
                                 "seq_sum", "roi_gather")}

    def add(name, ops, nbytes):
        k[name][0] += ops
        k[name][1] += nbytes

    n1 = sum(int(t[0]) for t in types_by_stream)
    n2 = sum(int(t[1]) for t in types_by_stream)
    hd = H * W
    search_ops = 0.0
    for scale, (_, s2, _) in zip(scales, types_by_stream):
        h, w = lr_shape(scale, H, W)
        px, mbs = h * w, (h // MB) * (w // MB)
        ops = (T - 1) * mbs * cand * MB * MB * 2.0
        search_ops += ops
        add("motion_sad", ops, (T - 1) * (2 * px * store + mbs * 12))
        add("blockdct", T * px * DCT_OPS_PX, T * px * 12)       # I/P encode
        add("blockdct", s2 * px * DCT_HALF_OPS_PX, s2 * px * 8)  # residuals
        add("qtransfer", (T - 1) * px, (T - 1) * px * 8)   # compensation
        grid8, grid16 = px // 64, px // 256
        n_sum = T * grid8 + (2 * T - 1) * grid16 + 2 * T
        add("seq_sum", n_sum, n_sum * 4)
    add("blockdct", n1 * hd * DCT_OPS_PX, n1 * hd * 12)          # anchors
    if cfg["anchor_search"]:
        add("blockdct", ANCHOR_RUNGS * n1 * hd * DCT_HALF_OPS_PX,
            ANCHOR_RUNGS * n1 * hd * 8)
        n_sum = ANCHOR_RUNGS * n1 * (hd // 64) + len(scales) * T
        add("seq_sum", n_sum, n_sum * 4)
    add("qtransfer", n2 * hd, n2 * hd * 12)                # quality transfer
    if roi is not None:
        P = roi["region_px"] + 2 * roi["halo"]
        patches = (n1 + n2) * roi["capacity"]
        add("roi_gather", 0.0, patches * P * P * 8)
        det_ops = patches * conv_ops(det, P, P)
    else:
        det_ops = (n1 + n2) * conv_ops(det, H, W)
    dct_ops = k["blockdct"][0]
    return Work(kernels=k, step_ops=det_ops + search_ops + dct_ops)


def _diamond_steps(radius: int) -> tuple:
    s = 1
    while s * 2 <= radius:
        s *= 2
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    return tuple(steps)
