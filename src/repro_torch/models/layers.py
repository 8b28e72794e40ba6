"""Dense decoder-LM layers (port of the dense-LM part of
``repro.models.layers``).

Conventions, as in the reference:

* activations (batch, seq, d); attention tensors q (B, Sq, H, D) and k/v
  (B, Sk, Hk, D) with GQA groups G = H // Hk, query head h reading kv
  head h // G;
* a matmul the reference takes with ``preferred_element_type=f32`` takes
  exact bf16 products and f32 sums here too (:func:`mm_f32`); softmax is
  in f32; outputs are cast back to the activation dtype.

``chunked_attention`` and ``swa_attention`` are the reference's XLA path
(``attention_impl="xla"``), written as plain PyTorch; the hand-written
kernel is ``repro_torch.kernels.flash_attention``.  The reference's
``constrain``, ``scan_unroll`` and ``set_dryrun_unroll`` place XLA
sharding constraints and unroll scans for its dry run: the port runs on
one device, eagerly, and has no counterpart.  ``layer_norm``, ``gelu_mlp``
and the MoE layers wait for the slices that need them (ROADMAP.md
queues 3 and 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

f32 = torch.float32
bf16 = torch.bfloat16
NEG_INF = -1e30


class _MmF32(torch.autograd.Function):
    """The CUDA bf16 GEMM with an f32 result (``out_dtype``), which has no
    derivative in PyTorch, made differentiable.  The backward is the one
    autograd gives the CPU path, ``a.float() @ b.float()``: the f32
    cotangent times the widened other operand, f32 sums, rounded to the
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=f32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return ga, gb


def mm_f32(a, b):
    """``a @ b`` with an f32 result for bf16 ``a`` (..., M, K) and ``b``
    (K, N) or (..., K, N): XLA's ``preferred_element_type=f32``, exact
    products and f32 sums.  On CUDA one cuBLAS bf16 GEMM with an f32
    output (``out_dtype``, which the CPU build lacks), through
    :class:`_MmF32` when autograd needs its gradient; on the CPU the
    operands are widened to f32, which gives the same exact products, as
    for f32 or mixed operands on either device."""
    if a.device.type != "cuda" or a.dtype != bf16 or b.dtype != bf16:
        return torch.matmul(a.float(), b.float())
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    lead = a.shape[:-1]
    if b.dim() == 2:
        a2 = a.reshape(-1, a.shape[-1])
        out = _MmF32.apply(a2, b) if grad \
            else torch.mm(a2, b, out_dtype=f32)
        return out.reshape(*lead, b.shape[-1])
    a3 = a.reshape(-1, *a.shape[-2:])
    b3 = b.expand(*a.shape[:-2], *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = _MmF32.apply(a3, b3) if grad else torch.bmm(a3, b3, out_dtype=f32)
    return out.reshape(*lead, b.shape[-1])


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=f32,
                                         device=device) / rot))


def apply_rope(x, positions, *, fraction: float = 1.0,
               theta: float = 10000.0):
    """x: (B, S, H, D); positions: (S,) or (B, S).  Rotates the first
    ``int(D * fraction)`` (even) dims as interleaved pairs, in f32."""
    D = x.shape[-1]
    rot = int(D * fraction)
    rot -= rot % 2
    inv = rope_freqs(D, fraction, theta, device=x.device)  # (rot/2,)
    pos = positions.to(f32)
    if pos.dim() == 1:
        pos = pos[None, :]                                  # (1, S)
    ang = pos[..., None] * inv[None, None, :]               # (B?, S, rot/2)
    sin = torch.sin(ang)[:, :, None, :]                     # (B?, S, 1, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# Attention: chunked online softmax (full/causal), SWA q blocks, decode
# --------------------------------------------------------------------------
def _repeat_kv(k, n_heads: int):
    """(B, S, Hk, D) -> (B, S, H, D), each kv head repeated G times."""
    G = n_heads // k.shape[2]
    if G == 1:
        return k
    return torch.repeat_interleave(k, G, dim=2)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      kv_positions=None, chunk: int = 1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k, v: (B, Sk, Hk, D).  ``q_offset`` is the absolute
    position of q[0]; ``kv_positions`` (Sk,) the absolute positions of the
    cache slots (default arange); slots with position < 0 are masked out.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    q = q.to(bf16).transpose(1, 2)                          # (B, H, Sq, D)
    k = _repeat_kv(k, H).to(bf16).transpose(1, 2)           # (B, H, Sk, D)
    v = _repeat_kv(v, H).to(bf16).transpose(1, 2)
    if kv_positions is None:
        kv_positions = torch.arange(Sk, dtype=torch.int32, device=dev)
    q_pos = q_offset + torch.arange(Sq, dtype=torch.int32, device=dev)

    chunk = min(chunk, Sk)
    if Sk % chunk:
        chunk = Sk  # as the reference: one chunk
    scale = D ** -0.5
    m = torch.full((B, H, Sq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=f32, device=dev)
    for c0 in range(0, Sk, chunk):
        kb, vb = k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk]
        pb = kv_positions[c0:c0 + chunk]
        s = mm_f32(q, kb.transpose(-1, -2)) * scale         # (B, H, Sq, C)
        mask = pb[None, :] >= 0
        if causal:
            mask = mask & (pb[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + mm_f32(p.to(bf16), vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(bf16)                     # (B, Sq, H, D)


def swa_attention(q, k, v, *, window: int, q_offset: int = 0,
                  q_block: int = 1024):
    """Sliding-window causal attention: one softmax per q block over the
    ``window + q_block`` keys that can reach it."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    q = q.to(bf16).transpose(1, 2)
    k = _repeat_kv(k, H).to(bf16).transpose(1, 2)
    v = _repeat_kv(v, H).to(bf16).transpose(1, 2)
    qb = min(q_block, Sq)
    if Sq % qb:
        qb = Sq
    span = min(window + qb, Sk)
    scale = D ** -0.5
    outs = []
    for i in range(Sq // qb):
        q_pos = q_offset + i * qb + torch.arange(qb, dtype=torch.int32,
                                                 device=dev)
        ks = min(max(q_offset + i * qb + qb - span, 0), Sk - span)
        kb, vb = k[:, :, ks:ks + span], v[:, :, ks:ks + span]
        k_pos = ks + torch.arange(span, dtype=torch.int32, device=dev)
        s = mm_f32(q[:, :, i * qb:(i + 1) * qb], kb.transpose(-1, -2)) \
            * scale
        mask = (k_pos[None, :] <= q_pos[:, None]) & (
            q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(mm_f32(p.to(bf16), vb).to(bf16))
    return torch.cat(outs, dim=2).transpose(1, 2)           # (B, Sq, H, D)


def decode_attention(q, k_cache, v_cache, *, cache_positions, pos: int,
                     window: int | None = None):
    """Single-token attention over a (possibly ring) KV cache.

    q: (B, 1, H, D); caches: (B, S, Hk, D); cache_positions: (S,) int32,
    -1 for unwritten slots; pos: the current position.
    """
    B, _, H, D = q.shape
    Hk = k_cache.shape[2]
    qg = q.reshape(B, Hk, H // Hk, D).to(bf16)              # (B, Hk, G, D)
    kc = k_cache.to(bf16).permute(0, 2, 3, 1)               # (B, Hk, D, S)
    s = mm_f32(qg, kc) * D ** -0.5                          # (B, Hk, G, S)
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if window is not None:
        valid = valid & (pos - cache_positions < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = mm_f32(p.to(bf16), v_cache.to(bf16).transpose(1, 2))  # (B, Hk, G, D)
    return o.reshape(B, 1, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def swiglu(x, w1, w3, w2):
    h = mm_f32(x, w1)
    g = mm_f32(x, w3)
    h = (F.silu(h) * g).to(x.dtype)
    return h @ w2  # the reference's bf16 result
