"""Block-matching motion search: the CUDA kernel's wrapper and its plain
PyTorch versions.

Port of ``repro/kernels/motion_sad``: the exhaustive and the diamond
search, each in f32 or bf16 storage (inputs rounded to bf16, every SAD
summed in f32), over one frame (H, W) or a batch (T, H, W).  The kernel
is ``kernels/csrc/motion_sad.cu``; ``motion_sad_plain`` and
``motion_sad_diamond_plain`` are the same functions in PyTorch, taken for
CPU tensors and used as the kernel's reference on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MB = 16
SEARCHES = ("exhaustive", "diamond")
# the largest search radius the kernel takes (the plain versions take any)
MAX_RADIUS = 67
f32 = torch.float32


def diamond_steps(radius: int) -> tuple:
    """Step schedule of the diamond search: the largest power of two
    <= radius, halving down to 1 (``repro.codec.motion.diamond_steps``)."""
    s = 1
    while s * 2 <= radius:
        s *= 2
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    return tuple(steps)


def _batched(plain):
    """A plain search over one (H, W) frame, taking (T, H, W) frames too:
    one frame at a time, the results stacked."""
    @functools.wraps(plain)
    def search(cur, ref, radius: int = 8, *, dtype=None):
        if cur.dim() == 2:
            return plain(cur, ref, radius, dtype=dtype)
        mvs, sads = zip(*(plain(c, r, radius, dtype=dtype)
                          for c, r in zip(cur, ref)))
        return torch.stack(mvs), torch.stack(sads)
    return search


def _windows(cur, ref, radius: int, dtype):
    """The searches' shared head (``repro.codec.motion._search_prelude``):
    inputs rounded to the storage dtype and back to f32, the current
    blocks (nby, nbx, MB, MB) and each block's (MB+2R)^2 edge-padded
    window (nby, nbx, win, win)."""
    store = build.storage_dtype(dtype)
    cur, ref = (x.to(store).to(f32) for x in (cur, ref))
    H, W = cur.shape
    nby, nbx = H // MB, W // MB
    win = MB + 2 * radius
    refp = F.pad(ref[None, None], (radius,) * 4, mode="replicate")[0, 0]
    wins = refp.unfold(0, win, MB).unfold(1, win, MB)
    curb = cur.reshape(nby, MB, nbx, MB).permute(0, 2, 1, 3)
    return curb, wins


@_batched
def motion_sad_plain(cur, ref, radius: int = 8, *, dtype=None):
    """Exhaustive search, per macroblock (``repro.codec.motion.block_sad``):
    each block's window is cut once, candidates run dy-major and a strict
    ``<`` keeps the first of equal SADs.  Returns (mv (nby, nbx, 2) int32
    (dy, dx), sad (nby, nbx) f32); over (T, H, W) frames, each with a
    leading T."""
    curb, wins = _windows(cur, ref, radius, dtype)
    side = 2 * radius + 1
    best_sad = torch.full(curb.shape[:2], float("inf"), dtype=f32,
                          device=cur.device)
    best_idx = torch.zeros(curb.shape[:2], dtype=torch.int64,
                           device=cur.device)
    for k in range(side * side):
        oy, ox = divmod(k, side)
        cand = wins[:, :, oy:oy + MB, ox:ox + MB]
        sad = (curb - cand).abs().sum(dim=(2, 3))
        better = sad < best_sad
        best_sad = torch.where(better, sad, best_sad)
        best_idx = torch.where(better, k, best_idx)
    mv = torch.stack([best_idx // side - radius, best_idx % side - radius],
                     dim=-1)
    return mv.to(torch.int32), best_sad


@_batched
def motion_sad_diamond_plain(cur, ref, radius: int = 8, *, dtype=None):
    """Diamond search (``repro.codec.motion.block_sad_diamond``): SAD at
    (0, 0), then for each step of ``diamond_steps(radius)`` the 3x3
    probes around the best offset found before that round, dy-major,
    clipped to +-R, strict ``<``.  Returns (mv, sad) as
    :func:`motion_sad_plain`."""
    curb, wins = _windows(cur, ref, radius, dtype)
    nby, nbx = curb.shape[:2]
    dev = cur.device
    ar = torch.arange(MB, device=dev)
    bi = torch.arange(nby, device=dev)[:, None, None, None]
    bj = torch.arange(nbx, device=dev)[None, :, None, None]

    def sad_at(oy, ox):
        ys = (oy + radius)[..., None] + ar                 # (nby, nbx, MB)
        xs = (ox + radius)[..., None] + ar
        cand = wins[bi, bj, ys[..., :, None], xs[..., None, :]]
        return (curb - cand).abs().sum(dim=(2, 3))

    best_y = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
    best_x = torch.zeros_like(best_y)
    best_sad = sad_at(best_y, best_x)
    for s in diamond_steps(radius):
        cy, cx = best_y, best_x
        for py in (-s, 0, s):
            for px in (-s, 0, s):
                oy = (cy + py).clamp(-radius, radius)
                ox = (cx + px).clamp(-radius, radius)
                sad = sad_at(oy, ox)
                better = sad < best_sad
                best_sad = torch.where(better, sad, best_sad)
                best_y = torch.where(better, oy, best_y)
                best_x = torch.where(better, ox, best_x)
    return torch.stack([best_y, best_x], dim=-1).to(torch.int32), best_sad


_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, *[ctypes.c_int] * 6, _P, _P, _P]


def launch_name(search: str = "exhaustive", dtype=None) -> str:
    """The launch counter's name of one form of the kernel:
    ``motion_sad``, ``motion_sad_bf16``, ``motion_sad_diamond`` or
    ``motion_sad_diamond_bf16``."""
    return ("motion_sad" + ("_diamond" if search == "diamond" else "")
            + ("_bf16" if build.storage_dtype(dtype) == torch.bfloat16
               else ""))


def motion_sad(cur, ref, radius: int = 8, *, dtype=None,
               search: str = "exhaustive"):
    """cur/ref: (H, W) or (T, H, W), H and W multiples of 16 -> (mv (...,
    nby, nbx, 2) int32 (dy, dx), sad (..., nby, nbx) f32) as in
    :func:`motion_sad_plain`.  ``search`` is "exhaustive" or "diamond";
    ``dtype`` is the storage dtype (None for f32, or torch.bfloat16);
    ``radius`` >= 0, as in the reference.  CPU tensors take the plain
    versions, at any radius; CUDA tensors launch the kernel, all T frames
    at once, for radii up to MAX_RADIUS (ValueError above it).  Raises
    under autograd."""
    build.refuse_grad("motion_sad", cur, ref)
    if search not in SEARCHES:
        raise ValueError(f"unknown search strategy {search!r} "
                         f"(expected one of {SEARCHES})")
    store = build.storage_dtype(dtype)
    if cur.shape != ref.shape or cur.dim() not in (2, 3) \
            or 0 in cur.shape or cur.shape[-2] % MB or cur.shape[-1] % MB:
        raise ValueError(f"cur/ref must be equal, non-empty (H, W) or (T, "
                         f"H, W) with H, W multiples of {MB}; got "
                         f"{tuple(cur.shape)}, {tuple(ref.shape)}")
    if radius < 0:
        raise ValueError(f"search radius must be >= 0, got {radius}")
    if cur.device.type == "cpu":
        plain = motion_sad_diamond_plain if search == "diamond" \
            else motion_sad_plain
        return plain(cur, ref, radius, dtype=dtype)
    if cur.device.type != "cuda":
        raise ValueError(f"motion_sad runs on cpu or cuda, not {cur.device}")
    if radius > MAX_RADIUS:
        raise ValueError(f"search radius must be in [0, {MAX_RADIUS}] on "
                         f"CUDA, got {radius}")
    cur, ref = (x.to(store).contiguous() for x in (cur, ref))
    for name, t in (("cur", cur), ("ref", ref)):
        build.check_cuda_tensor(name, t, store, cur.device)
    *lead, H, W = cur.shape
    frames = lead[0] if lead else 1
    mv = torch.empty((*lead, H // MB, W // MB, 2), dtype=torch.int32,
                     device=cur.device)
    sad = torch.empty((*lead, H // MB, W // MB), dtype=f32, device=cur.device)
    fn = build.kernel_function("motion_sad", "motion_sad_launch", _ARGTYPES)
    build.launch(launch_name(search, dtype), fn, cur.device, build.ptr(cur),
                 build.ptr(ref), frames, H, W, radius,
                 int(search == "diamond"), int(store == torch.bfloat16),
                 build.ptr(mv), build.ptr(sad))
    return mv, sad
