"""Shared layers of the model zoo (port of ``repro.models.layers``:
norms, RoPE, attention, the SwiGLU and GELU MLPs and the mixture of
experts), and the NHWC convolution and max pool with XLA's padding rule.

Conventions, as in the reference:

* activations (batch, seq, d) or NHWC for vision; attention tensors q
  (B, Sq, H, D) and k/v (B, Sk, Hk, D) with GQA groups G = H // Hk, query
  head h reading kv head h // G;
* a matmul the reference takes with ``preferred_element_type=f32`` takes
  exact bf16 products and f32 sums here too (:func:`mm_f32`); softmax is
  in f32; outputs are cast back to the activation dtype.

``chunked_attention`` and ``swa_attention`` are the reference's XLA path
(``attention_impl="xla"``), written as plain PyTorch; the hand-written
kernel is ``repro_torch.kernels.flash_attention``.  ``constrain`` marks
an activation's logical axes at the reference's call sites: the port
partitions no step, so it returns the tensor as it is, but under a
``shard_ctx`` (the dry run's production meshes) it first places the
axes on the mesh and raises where the reference's would.  The
reference's ``scan_unroll`` and ``set_dryrun_unroll`` have no
counterpart: the port loops over layers, chunks and blocks in Python, so
there is no scan to unroll.

The reference convolves with ``lax.conv_general_dilated`` on NHWC
activations and HWIO kernels; :func:`conv_nhwc` keeps both layouts at its
interface and hands cuDNN the activations as a channels-last NCHW view
(no copy).  ``padding="SAME"`` is XLA's rule (:func:`same_pad`), which
puts the odd pixel after: a 3x3 stride-2 convolution of an even size
pads (0, 1), where ``F.conv2d(padding=1)`` would pad (1, 1).

The MoE layers (``router_topk``, ``moe_sorted_dispatch``,
``moe_gathered_experts``, ``moe_block``) are plain PyTorch, as the
reference's are plain XLA: the expert products are cuBLAS bf16 GEMMs with
f32 results (:func:`mm_f32`).  Where the reference leaves an order to
XLA, the port fixes the one XLA's CPU backend takes: top-k ties go to the
lower expert index, and a token's k weighted expert outputs are added in
bf16 one at a time, in ascending expert order (the order of the sorted
dispatch's scatter-add).  ``MOE_BRANCHES`` counts the branch each call
takes.
"""
from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn.functional as F

f32 = torch.float32
bf16 = torch.bfloat16
NEG_INF = -1e30

# distributed.context's stack of shard contexts, bound at the first
# ``constrain`` (importing it here would cycle through the distributed
# package, which imports the detector and so this module)
_CTX_STACK = None


def constrain(x, *logical_axes):
    """``x`` unchanged.  Under a ``shard_ctx`` the logical axes are first
    placed on the ambient mesh (``named_sharding`` against ``x``'s shape,
    dimensions that do not divide replicated), which raises where the
    reference's ``with_sharding_constraint`` does: a rule naming an axis
    the mesh lacks (``KeyError``), one mesh axis for two dimensions
    (``ValueError``)."""
    global _CTX_STACK
    if _CTX_STACK is None:
        from repro_torch.distributed.context import _CTX
        _CTX_STACK = _CTX
    if _CTX_STACK:
        from repro_torch.distributed.sharding import named_sharding
        ctx = _CTX_STACK[-1]
        named_sharding(ctx.mesh, logical_axes, ctx.rules, x.shape)
    return x


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


def layer_norm(x, weight, bias, eps: float = 1e-6):
    """LayerNorm over the last dim in f32 (the population variance), cast
    back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def take_clip(table, idx):
    """``table.at[idx].get(mode="clip")``: rows of ``table`` at integer
    ``idx``; a negative index counts from the end once (JAX normalises
    indices before it clips), then every index is clamped into the
    table."""
    n = table.shape[0]
    idx = idx.long()
    return table[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


# --------------------------------------------------------------------------
# Convolutions (NHWC activations, HWIO kernels)
# --------------------------------------------------------------------------
def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's padding="SAME" of one spatial dim: (low, high) with ``total =
    max((out - 1) * stride + k - size, 0)`` for ``out = ceil(size /
    stride)``, ``total // 2`` low and the rest high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh: int, kw: int, stride: int, value: float = 0.0):
    """x (B, H, W, C) padded by :func:`same_pad` in H and W."""
    ph = same_pad(x.shape[1], kh, stride)
    pw = same_pad(x.shape[2], kw, stride)
    if not any(ph + pw):
        return x
    return F.pad(x, (0, 0, *pw, *ph), value=value)


def conv_nhwc(x, w, stride: int = 1, padding: str = "SAME",
              groups: int = 1):
    """``lax.conv_general_dilated(x, w, (stride, stride), padding,
    dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=
    groups)``: x (B, H, W, Cin), w (kh, kw, Cin / groups, Cout) -> (B, H',
    W', Cout) in x's dtype (w is cast to it).  ``padding`` is "SAME" or
    "VALID"."""
    if padding == "SAME":
        x = _pad_same(x, w.shape[0], w.shape[1], stride)
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def max_pool_nhwc(x, k: int, stride: int):
    """``lax.reduce_window(x, -inf, lax.max, (1, k, k, 1), (1, stride,
    stride, 1), "SAME")`` on x (B, H, W, C): -inf padding by
    :func:`same_pad`, then the pool without padding."""
    x = _pad_same(x, k, k, stride, value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


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
    q, k, v = (constrain(t, "batch", None, "tensor", None).transpose(1, 2)
               for t in (q.to(bf16), _repeat_kv(k, H).to(bf16),
                         _repeat_kv(v, H).to(bf16)))        # (B, H, S, D)
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
        acc = constrain(acc * corr[..., None] + mm_f32(p.to(bf16), vb),
                        "batch", "tensor", None, None)
        m = constrain(m_new, "batch", "tensor", None)
        l = constrain(l, "batch", "tensor", None)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return constrain(out.transpose(1, 2).to(bf16),
                     "batch", None, "tensor", None)         # (B, Sq, H, D)


def swa_attention(q, k, v, *, window: int, q_offset: int = 0,
                  q_block: int = 1024):
    """Sliding-window causal attention: one softmax per q block over the
    ``window + q_block`` keys that can reach it."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    q, k, v = (constrain(t, "batch", None, "tensor", None).transpose(1, 2)
               for t in (q.to(bf16), _repeat_kv(k, H).to(bf16),
                         _repeat_kv(v, H).to(bf16)))        # (B, H, S, D)
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
        outs.append(constrain(mm_f32(p.to(bf16), vb).to(bf16).transpose(
            1, 2), "batch", None, "tensor", None))          # (B, qb, H, D)
    return constrain(torch.cat(outs, dim=1), "batch", None, "tensor", None)


def decode_attention(q, k_cache, v_cache, *, cache_positions, pos: int,
                     window: int | None = None):
    """Single-token attention over a (possibly ring) KV cache.

    q: (B, 1, H, D); caches: (B, S, Hk, D); cache_positions: (S,) int32,
    -1 for unwritten slots; pos: the current position.
    """
    B, _, H, D = q.shape
    Hk = k_cache.shape[2]
    qg = constrain(q.reshape(B, Hk, H // Hk, D).to(bf16),
                   "batch", None, None, None)               # (B, Hk, G, D)
    kc = k_cache.to(bf16).permute(0, 2, 3, 1)               # (B, Hk, D, S)
    s = constrain(mm_f32(qg, kc) * D ** -0.5,
                  "batch", None, None, "seq_kv")            # (B, Hk, G, S)
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if window is not None:
        valid = valid & (pos - cache_positions < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = mm_f32(p.to(bf16), v_cache.to(bf16).transpose(1, 2))  # (B, Hk, G, D)
    return constrain(o.reshape(B, 1, H, D).to(q.dtype),
                     "batch", None, None, None)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def swiglu(x, w1, w3, w2):
    h = mm_f32(x, w1)
    g = mm_f32(x, w3)
    h = (F.silu(h) * g).to(x.dtype)
    return h @ w2  # the reference's bf16 result


def gelu_mlp(x, w1, b1, w2, b2):
    """x @ w1 (f32 result) + b1, GELU (jax.nn.gelu's default, the tanh
    form), in x's dtype @ w2 (a result in x's dtype, as the reference's
    einsum), + b2 in f32, cast back."""
    h = mm_f32(x, w1)
    h = F.gelu(h + b1.float(), approximate="tanh").to(x.dtype)
    y = h @ w2
    return (y.float() + b2.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------
# calls of each MoE branch: "sorted", "gathered" and "expert_parallel"
# (the sharded block, one a call, besides its shards' local branches)
MOE_BRANCHES: collections.Counter = collections.Counter()


def reset_moe_branches() -> None:
    MOE_BRANCHES.clear()


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    norm_topk: bool = True          # qwen renormalizes top-k probs


def _topk(probs, k: int):
    """``lax.top_k``: the k largest of each row, a tie going to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def router_topk(x, w_router, moe: MoEConfig):
    """Returns (expert_idx (T, k) int64, weights (T, k) in x's dtype,
    the Switch-style load-balance loss, an f32 scalar)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = _topk(probs, moe.top_k)
    if moe.norm_topk:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    # every addend is the same value, so the order of the adds (atomics
    # on CUDA) cannot change the sum
    ce = torch.zeros(moe.n_experts, dtype=f32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.full((idx.numel(),), 1.0 / idx.numel(),
                                       dtype=f32, device=x.device))
    aux = moe.n_experts * torch.sum(me * ce)
    return idx, w.to(x.dtype), aux


def capacity(T: int, moe: MoEConfig) -> int:
    """The sorted dispatch's slots an expert, the reference's expression."""
    k = moe.top_k
    C = max(k, int(T * k * moe.capacity_factor / moe.n_experts + 0.999))
    return min(C, T)


def _swiglu_experts(buf, w1, w3, w2):
    """(E, C, d) -> (E, C, d): each expert's SwiGLU on its slots, the
    products bf16 with f32 results, rounded as the reference's."""
    h = mm_f32(buf, w1)
    g = mm_f32(buf, w3)
    h = (F.silu(h) * g).to(buf.dtype)
    return mm_f32(h, w2).to(buf.dtype)


def _combine(contrib, order, idx):
    """(T, d): each token's k rows of ``contrib`` ((T·k, d) in the
    dispatch's sorted order) added in its dtype one at a time, starting
    from 0, in ascending expert order: the order in which the reference's
    ``zeros.at[tok].add(contrib)`` meets them on XLA's CPU backend, fixed
    here on every device (CUDA's ``index_add_`` adds in no fixed order)."""
    T, k = idx.shape
    d = contrib.shape[-1]
    by_slot = torch.empty_like(contrib)
    by_slot[order] = contrib
    by_slot = by_slot.reshape(T, k, d)
    rank = torch.argsort(idx, dim=1)                        # (T, k)
    by_expert = by_slot.gather(1, rank[..., None].expand(T, k, d))
    out = torch.zeros((T, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = out + by_expert[:, j]
    return out


def moe_sorted_dispatch(x, w_router, w1, w3, w2, moe: MoEConfig):
    """Dropping MoE via sort-based dispatch into (E, C, d) capacity
    buffers.  x: (T, d) tokens; w1/w3 (E, d, f), w2 (E, f, d).  Returns
    (out (T, d), aux).  Tokens go into the buffers in (expert, token,
    slot) order, the slots past C dropped; after the expert GEMMs each
    token's k weighted outputs (zero where dropped) are added in bf16 in
    ascending expert order (:func:`_combine`)."""
    MOE_BRANCHES["sorted"] += 1
    idx, w, aux = router_topk(x, w_router, moe)
    T, d = x.shape
    E, k = moe.n_experts, moe.top_k
    C = capacity(T, moe)
    eflat = idx.reshape(-1)                                 # (T*k,)
    order = torch.argsort(eflat, stable=True)
    sorted_e = eflat[order]
    # bincount would read its maximum back to the host (a wait for the
    # device a layer); integer adds come out the same in any order
    counts = torch.zeros(E, dtype=eflat.dtype, device=x.device) \
        .index_add_(0, eflat, torch.ones_like(eflat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[sorted_e]
    tok = order // k
    # the slots past C are written to a spare slot C of the buffer, which
    # no product reads, and read back as 0: no boolean mask, so no wait
    # for the device
    kept = (pos < C)[:, None]
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[sorted_e, torch.clamp(pos, max=C)] = x[tok]
    y = _swiglu_experts(buf[:, :C], w1, w3, w2)
    contrib = torch.where(kept, y[sorted_e, torch.clamp(pos, max=C - 1)], 0)
    contrib = contrib * w.reshape(-1)[order][:, None]
    return _combine(contrib, order, idx), aux


def moe_gathered_experts(x, w_router, w1, w3, w2, moe: MoEConfig):
    """Decode-shape MoE: each token through its k experts' weights,
    gathered a token ((T, k, d, f) copies, as the reference's); the
    combine an f32 sum over k, rounded once.  Returns (out (T, d), aux)."""
    MOE_BRANCHES["gathered"] += 1
    idx, w, aux = router_topk(x, w_router, moe)
    T, d = x.shape
    k = idx.shape[1]
    xk = x[:, None, None, :].expand(T, k, 1, d)             # (T, k, 1, d)
    h = mm_f32(xk, w1[idx])
    g = mm_f32(xk, w3[idx])
    h = (F.silu(h) * g).to(x.dtype)                         # (T, k, 1, f)
    y = mm_f32(h, w2[idx])[:, :, 0]                         # (T, k, d) f32
    out = (y * w.float()[..., None]).sum(1)
    return out.to(x.dtype), aux


def _moe_local(xf, w_router, w1, w3, w2, moe: MoEConfig):
    """The sorted dispatch when T·k >= E (each expert's weights read
    once), else the gathered path (only the k chosen experts read)."""
    if xf.shape[0] * moe.top_k >= moe.n_experts:
        return moe_sorted_dispatch(xf, w_router, w1, w3, w2, moe)
    return moe_gathered_experts(xf, w_router, w1, w3, w2, moe)


def moe_block(x, w_router, w1, w3, w2, moe: MoEConfig):
    """x: (B, S, d) -> ((B, S, d), aux).

    Under a ``shard_ctx`` whose rules give batch axes and a tensor axis
    larger than 1, with B divisible over the batch axes, d_ff over the
    tensor axis and B·S >= 4096 tokens (the reference's condition), the
    block runs expert-parallel: a shard a mesh device
    (:func:`repro_torch.distributed.shard_map_compat.shard_map_compat`),
    each routing its slice of the batch through its slice of every
    expert's d_ff; the shards' partial outputs are summed over the tensor
    axis in bf16 and their router losses averaged over the batch axes on
    the mesh's first device (the reference's ``psum`` and ``pmean``).
    Otherwise the local branch.
    """
    from repro_torch.distributed.context import current_ctx
    from repro_torch.distributed.shard_map_compat import shard_map_compat
    from repro_torch.distributed.sharding import P

    B, S, d = x.shape
    ctx = current_ctx()
    use_sm = (
        ctx is not None
        and ctx.runs_shards
        and len(ctx.batch_axes) > 0
        and B % ctx.axis_size(ctx.batch_axes) == 0
        and ctx.axis_size(ctx.tensor_axes) > 1
        and w1.shape[-1] % ctx.axis_size(ctx.tensor_axes) == 0
        and B * S >= 4096
    )
    if not use_sm:
        out, aux = _moe_local(x.reshape(B * S, d), w_router, w1, w3, w2, moe)
        return out.reshape(B, S, d), aux

    MOE_BRANCHES["expert_parallel"] += 1
    batch = ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
    tensor = ctx.tensor_axes[0]

    def body(xb, wr, a1, a3, a2):
        Bl = xb.shape[0]
        out, aux = _moe_local(xb.reshape(Bl * S, d), wr, a1, a3, a2, moe)
        return out.reshape(Bl, S, d), aux

    return shard_map_compat(
        body, mesh=ctx.mesh,
        in_specs=(P(batch), P(), P(None, None, tensor), P(None, None, tensor),
                  P(None, tensor, None)),
        out_specs=(P(batch), P()),
        reduce=(("sum", tensor), ("mean", batch)),
    )(x, w_router, w1, w3, w2)
