"""Flash attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro/kernels/flash_attention``.  Both take the model layout, q
(B, Sq, H, D) and k/v (B, Sk, Hk, D), with GQA (query head h reads kv head
h * Hk // H), a causal mask (k_pos <= q_pos, both counted from 0) and an
optional sliding window (q_pos - k_pos < window).  The kernel is
``kernels/csrc/flash_attention.cu``: its bf16 forms are a Hopper design
(TMA loads into a ring of K/V tiles, wgmma, a producer warpgroup and two
consumer warpgroups), its f32 form an mma.sync one; both count as
``"flash_attention"`` launches.  ``flash_attention_plain`` is the
reference's oracle ``ref.attention_ref`` in PyTorch (f32 math on the
inputs as given), taken for CPU tensors and used as the kernel's
reference on the card.  The kernel rounds q, k, v and the softmax
weights to bf16 before its products, as the Pallas kernel does; the
two agree within the reference's tolerance (0.02 for f32 inputs, 0.03
for bf16).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128)  # the kernel's instantiations


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Sk, Hk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, Hk, D) -> (B, Sq, H, D) in q's dtype:
    softmax(q k^T / sqrt(D)) v in f32 over the masked scores, masked
    entries set to -1e30 (``attention_ref``)."""
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qt = q.float().transpose(1, 2)                              # (B, H, Sq, D)
    kt = k.float().transpose(1, 2).repeat_interleave(G, dim=1)  # (B, H, Sk, D)
    vt = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    s = (qt @ kt.transpose(-1, -2)) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return (p @ vt).transpose(1, 2).to(q.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P]


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention as :func:`flash_attention_plain`, in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel: q, k, v
    contiguous, all f32 or all bf16, head dim 64 or 128.  Raises under
    autograd (:func:`repro_torch.kernels.build.refuse_grad`)."""
    _check(q, k, v, window)
    build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    dtype = build.storage_dtype(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda_tensor(name, t, dtype, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is built for {HEAD_DIMS}")
    out = torch.empty_like(q)
    fn = build.kernel_function("flash_attention", "flash_attention_launch",
                               _ARGTYPES)
    build.launch("flash_attention", fn, q.device, build.ptr(q),
                 build.ptr(k), build.ptr(v), build.ptr(out), B, Sq, Sk, H,
                 Hk, D, int(causal), -1 if window is None else int(window),
                 int(dtype == torch.bfloat16), 1.0 / math.sqrt(D))
    return out
