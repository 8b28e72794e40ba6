"""Decoder-only LM family: llama3, chatglm3, qwen2-moe, mixtral (port of
``repro.models.transformer_lm``: forward, the training loss, prefill and
KV-cache decode).

One config covers the four architectures: GQA with any kv-head count,
RoPE over a fraction of the head dim (chatglm's half rotation), an
optional sliding window (mixtral), optional q/k/v biases, and an optional
MoE FFN with a sigmoid-gated shared expert (qwen: 60 routed experts top-4
and a shared one; mixtral: 8 routed top-2).  Parameters are a dict of
tensors stacked over layers, in the reference's layouts: ``wq`` (L, d, H,
Dh), ``wk``/``wv`` (L, d, Hk, Dh), ``wo`` (L, H, Dh, d), ``w1``/``w3`` (L,
d, d_ff), ``w2`` (L, d_ff, d) or the experts' ``w_router`` (L, d, E),
``we1``/``we3`` (L, E, d, d_ff), ``we2`` (L, E, d_ff, d) and the shared
``ws1``/``ws3``/``ws2``, ``w_shared_gate`` (L, d, 1); ``embed`` (V, d),
tied to the output.
The layer loop is a Python loop over the stacked tensors; under autograd
with ``cfg.remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.

``attention_impl`` keeps the reference's two values, so a config maps
across one to one: ``"pallas"`` runs the hand-written CUDA kernel
(``repro_torch.kernels.flash_attention``, which has no backward and
raises under autograd, as the Pallas kernel cannot be differentiated),
``"xla"`` the plain ``chunked_attention``/``swa_attention`` of
``layers``.  The layers' router losses are summed into ``forward``'s aux.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.params import init_params, param_count, spec

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    rope_fraction: float = 1.0
    rope_theta: float = 500000.0
    window: Optional[int] = None          # SWA window (mixtral)
    moe: Optional[L.MoEConfig] = None
    d_ff_shared: int = 0                  # qwen shared-expert width
    qkv_bias: bool = False                # qwen
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True                    # recompute layers in the backward
    attn_chunk: int = 1024
    q_block: int = 1024
    aux_loss_coef: float = 0.01           # the MoE router loss's weight
    attention_impl: str = "xla"           # xla | pallas (the CUDA kernel)
    kv_cache_dtype: str = "bfloat16"      # bfloat16 | int8 (quantized cache)

    def __post_init__(self):
        if self.attention_impl not in ("xla", "pallas"):
            raise ValueError(f"attention_impl must be 'xla' or 'pallas', "
                             f"got {self.attention_impl!r}")
        if self.kv_cache_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bfloat16' or 'int8', "
                             f"got {self.kv_cache_dtype!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        return self.window is not None

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        return param_count(param_specs(self))

    def active_param_count(self) -> int:
        """6·N_active·D convention: MoE counts only top-k + shared experts."""
        if self.moe is None:
            return self.param_count()
        per_expert = 3 * self.d_model * self.d_ff
        inactive = (self.moe.n_experts - self.moe.top_k) * per_expert
        return self.param_count() - self.n_layers * inactive


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
def param_specs(cfg: LMConfig) -> dict:
    Ln, d, H, Hk, Dh = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                        cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.torch_dtype
    blk = {
        "ln1": spec((Ln, d), (None, None), dtype=dt, init="ones"),
        "ln2": spec((Ln, d), (None, None), dtype=dt, init="ones"),
        "wq": spec((Ln, d, H, Dh), (None, "fsdp", "tensor", None), dtype=dt,
                   init="fan_in"),
        "wk": spec((Ln, d, Hk, Dh), (None, "fsdp", "tensor", None), dtype=dt,
                   init="fan_in"),
        "wv": spec((Ln, d, Hk, Dh), (None, "fsdp", "tensor", None), dtype=dt,
                   init="fan_in"),
        "wo": spec((Ln, H, Dh, d), (None, "tensor", None, "fsdp"), dtype=dt,
                   init="fan_in"),
    }
    if cfg.qkv_bias:
        blk["bq"] = spec((Ln, H, Dh), (None, "tensor", None), dtype=dt,
                         init="zeros")
        blk["bk"] = spec((Ln, Hk, Dh), (None, "tensor", None), dtype=dt,
                         init="zeros")
        blk["bv"] = spec((Ln, Hk, Dh), (None, "tensor", None), dtype=dt,
                         init="zeros")
    if cfg.moe is None:
        blk.update({
            "w1": spec((Ln, d, cfg.d_ff), (None, "fsdp", "tensor"), dtype=dt,
                       init="fan_in"),
            "w3": spec((Ln, d, cfg.d_ff), (None, "fsdp", "tensor"), dtype=dt,
                       init="fan_in"),
            "w2": spec((Ln, cfg.d_ff, d), (None, "tensor", "fsdp"), dtype=dt,
                       init="fan_in"),
        })
    else:
        E = cfg.moe.n_experts
        blk.update({
            "w_router": spec((Ln, d, E), (None, "fsdp", None), dtype=dt,
                             init="fan_in"),
            "we1": spec((Ln, E, d, cfg.d_ff),
                        (None, "expert", "fsdp", "tensor"), dtype=dt,
                        init="fan_in"),
            "we3": spec((Ln, E, d, cfg.d_ff),
                        (None, "expert", "fsdp", "tensor"), dtype=dt,
                        init="fan_in"),
            "we2": spec((Ln, E, cfg.d_ff, d),
                        (None, "expert", "tensor", "fsdp"), dtype=dt,
                        init="fan_in"),
        })
        if cfg.d_ff_shared:
            blk.update({
                "ws1": spec((Ln, d, cfg.d_ff_shared), (None, "fsdp", "tensor"),
                            dtype=dt, init="fan_in"),
                "ws3": spec((Ln, d, cfg.d_ff_shared), (None, "fsdp", "tensor"),
                            dtype=dt, init="fan_in"),
                "ws2": spec((Ln, cfg.d_ff_shared, d), (None, "tensor", "fsdp"),
                            dtype=dt, init="fan_in"),
                "w_shared_gate": spec((Ln, d, 1), (None, "fsdp", None),
                                      dtype=dt, init="fan_in"),
            })
    return {
        "embed": spec((cfg.vocab, d), ("tensor", None), dtype=dt),
        "blocks": blk,
        "final_ln": spec((d,), (None,), dtype=dt, init="ones"),
    }


def _layer(params, i: int) -> dict:
    return {k: v[i] for k, v in params["blocks"].items()}


def _embed(params, cfg: LMConfig, tokens):
    """The reference's ``embed.at[tokens].get(mode="clip")``."""
    return L.take_clip(params["embed"], tokens).to(cfg.torch_dtype)


def _logits(params, cfg: LMConfig, x):
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return L.constrain(L.mm_f32(x, params["embed"].t()),
                       "batch", None, "tensor")


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------
def _ffn(cfg: LMConfig, p, x):
    """Per-layer FFN, (out, router loss); p holds this layer's weights.
    A dense layer's loss is 0.0."""
    if cfg.moe is None:
        return L.swiglu(x, p["w1"], p["w3"], p["w2"]), 0.0
    out, aux = L.moe_block(x, p["w_router"], p["we1"], p["we3"], p["we2"],
                           cfg.moe)
    if cfg.d_ff_shared:
        sh = L.swiglu(x, p["ws1"], p["ws3"], p["ws2"])
        gate = torch.sigmoid(x.float() @ p["w_shared_gate"].float())
        out = out + (sh.float() * gate).to(x.dtype)
    return out, aux


def _qkv(cfg: LMConfig, p, x, positions):
    """Rotated q (B, S, H, Dh) and k, v (B, S, Hk, Dh) in x's dtype."""
    B, S, d = x.shape

    def proj(w, bias):
        t = L.mm_f32(x, w.reshape(d, -1)).reshape(B, S, *w.shape[1:])
        if cfg.qkv_bias:
            t = t + p[bias].float()
        return L.constrain(t.to(x.dtype), "batch", None, "tensor", None)

    q, k, v = proj(p["wq"], "bq"), proj(p["wk"], "bk"), proj(p["wv"], "bv")
    rope = dict(fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    return (L.apply_rope(q, positions, **rope),
            L.apply_rope(k, positions, **rope), v)


def _attn(cfg: LMConfig, p, x, positions):
    """Returns (attn_out, (k, v)) for this layer over the whole sequence.
    (The reference's ``kv_override`` branch has no caller there; decode
    has its own body, :func:`decode_step`.)"""
    B, S, d = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    if cfg.attention_impl == "pallas":
        o = flash_attention(q, k, v, causal=True, window=cfg.window)
    elif cfg.window is not None and S > cfg.q_block:
        o = L.swa_attention(q, k, v, window=cfg.window, q_block=cfg.q_block)
    else:
        o = L.chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    # the reference's einsum promotes (bf16 attention into f32 weights);
    # with bf16 weights a bf16 result
    wo = p["wo"].reshape(-1, d)
    out = o.reshape(B, S, -1).to(torch.promote_types(o.dtype, wo.dtype)) @ wo
    return L.constrain(out.to(x.dtype), "batch", None, None), (k, v)


def _block(cfg: LMConfig, p, x, positions):
    """One layer: (x after attention and FFN, (k, v), router loss)."""
    h, kv = _attn(cfg, p, L.rms_norm(x, p["ln1"], cfg.norm_eps), positions)
    x = L.constrain(x + h, "batch", None, None)
    h, aux = _ffn(cfg, p, L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return L.constrain(x + h, "batch", None, None), kv, aux


def _trunk(params, cfg: LMConfig, tokens, collect_cache: bool):
    """Embedding and layers: (final hidden (B, S, d), cache_kv or None,
    the layers' router losses summed in layer order, 0.0 if dense).
    Under autograd with ``cfg.remat`` a layer keeps only its input for the
    backward and runs again there; the values are the same."""
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = L.constrain(_embed(params, cfg, tokens), "batch", None, None)
    remat = cfg.remat and torch.is_grad_enabled()
    # one unbind a tensor: its backward stacks the layers' gradients once
    names = list(params["blocks"])
    layers = zip(*(params["blocks"][k].unbind(0) for k in names))
    ks, vs = [], []
    aux = 0.0
    for values in layers:
        p = dict(zip(names, values))
        if remat:
            x, (k, v), a = checkpoint(_block, cfg, p, x, positions,
                                      use_reentrant=False)
        else:
            x, (k, v), a = _block(cfg, p, x, positions)
        aux = aux + a
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, cache, aux


def forward(params, cfg: LMConfig, tokens, *, collect_cache: bool = False):
    """Full-sequence forward.  tokens: (B, S) int.

    Returns (logits (B, S, V) f32, aux_loss, cache_kv): aux_loss is the
    layers' router losses summed (an f32 scalar; 0.0 for a dense model);
    cache_kv is (k, v), each (L, B, S, Hk, Dh) after RoPE, if
    ``collect_cache`` else None.
    """
    x, cache, aux = _trunk(params, cfg, tokens, collect_cache)
    return _logits(params, cfg, x), aux, cache


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------
def softmax_xent(logits, labels):
    """Mean cross-entropy: the log-sum-exp minus the gold logit.  The gold
    logit is gathered; the reference's one-hot einsum sums it with zeros,
    the same value."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def loss_fn(params, cfg: LMConfig, batch):
    """Next-token loss of ``batch`` {"tokens", "labels"} (B, S) int, plus
    ``aux_loss_coef`` times the mean router loss a layer (0 for a dense
    model)."""
    logits, aux, _ = forward(params, cfg, batch["tokens"])
    ce = softmax_xent(logits, batch["labels"])
    return ce + cfg.aux_loss_coef * aux / max(cfg.n_layers, 1)


# --------------------------------------------------------------------------
# Decode (serve_step)
# --------------------------------------------------------------------------
def cache_len(cfg: LMConfig, seq_len: int) -> int:
    """Ring-buffer caches for SWA archs are bounded by the window."""
    if cfg.window is not None:
        return min(cfg.window, seq_len)
    return seq_len


def init_cache_specs(cfg: LMConfig, batch: int, seq_len: int) -> dict:
    Sc = cache_len(cfg, seq_len)
    quant = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if quant else cfg.torch_dtype
    shape = (cfg.n_layers, batch, Sc, cfg.n_kv_heads, cfg.head_dim)
    axes = (None, "batch", "seq_kv", None, None)
    specs = {
        "k": spec(shape, axes, dtype=dt, init="zeros"),
        "v": spec(shape, axes, dtype=dt, init="zeros"),
        "slot_pos": spec((Sc,), (None,), dtype=torch.int32, init="zeros"),
    }
    if quant:
        # per-(batch, slot, head) scales: +1/head_dim relative overhead
        for nm in ("k_scale", "v_scale"):
            specs[nm] = spec(shape[:-1], axes[:-1], dtype=f32, init="ones")
    return specs


def cache_from_prefill(cfg: LMConfig, kv, seq_len: int) -> dict:
    """The decode cache of ``init_cache_specs(cfg, B, seq_len)`` holding a
    prefill's k and v ((L, B, S, Hk, Dh) each, from :func:`prefill_step`):
    position p in the slot :func:`decode_step` writes it to (p mod the
    ring's length for a window config, else p), the latest positions
    kept when a window config's prefill is longer than its ring; the other
    slots empty (``slot_pos`` -1).  An int8 cache takes each position's
    quantised values and scales, as decode writes them.  (The reference
    has no such step: its decode cells start from an empty cache.)"""
    k, v = kv
    S = k.shape[2]
    Sc = cache_len(cfg, seq_len)
    if cfg.window is None and S > Sc:
        raise ValueError(f"a prefill of {S} positions does not fit a cache "
                         f"of {Sc}")
    cache = init_params(None, init_cache_specs(cfg, k.shape[1], seq_len),
                        k.device)
    pos = torch.arange(max(S - Sc, 0), S, device=k.device)
    slot = pos % Sc
    for name, t in (("k", k), ("v", v)):
        t = t[:, :, pos]
        if cfg.kv_cache_dtype == "int8":
            t, scale = _quantize_kv(t)
            cache[f"{name}_scale"][:, :, slot] = scale
        cache[name][:, :, slot] = t.to(cache[name].dtype)
    cache["slot_pos"].fill_(-1)
    cache["slot_pos"][slot] = pos.to(torch.int32)
    return cache


def _quantize_kv(x):
    """(..., D) -> (int8 values, (...) f32 scales): one scale a vector."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q, scale):
    return q.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def decode_step(params, cfg: LMConfig, cache: dict, tokens, pos):
    """One-token decode.  tokens: (B, 1) int; pos: the position (an int or
    a 0-d tensor).  The new token's k and v are written before it attends.

    Returns (logits (B, 1, V) f32, cache).  Unlike the reference, which
    returns a new cache, the cache is updated in place and returned: that
    saves copying every layer's (B, Sc, Hk, Dh) k and v on every step.
    """
    pos = int(pos)
    Sc = cache["k"].shape[2]
    positions = torch.tensor([pos], dtype=torch.int32, device=tokens.device)
    x = _embed(params, cfg, tokens)
    slot = pos % Sc if cfg.window is not None else min(pos, Sc - 1)
    cache["slot_pos"][slot] = pos
    quant = cfg.kv_cache_dtype == "int8"
    B, _, d = x.shape
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p, L.rms_norm(x, p["ln1"], cfg.norm_eps),
                       positions)
        if quant:
            for name, t in (("k", k), ("v", v)):
                tq, tsc = _quantize_kv(t)
                cache[name][i, :, slot] = tq[:, 0]
                cache[f"{name}_scale"][i, :, slot] = tsc[:, 0]
            k_full = _dequantize_kv(cache["k"][i], cache["k_scale"][i])
            v_full = _dequantize_kv(cache["v"][i], cache["v_scale"][i])
        else:
            cache["k"][i, :, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][i, :, slot] = v[:, 0].to(cache["v"].dtype)
            k_full, v_full = cache["k"][i], cache["v"][i]
        o = L.decode_attention(q, k_full, v_full,
                               cache_positions=cache["slot_pos"], pos=pos,
                               window=cfg.window)
        x = x + L.mm_f32(o.reshape(B, 1, -1),
                         p["wo"].reshape(-1, d)).to(x.dtype)
        x = x + _ffn(cfg, p, L.rms_norm(x, p["ln2"], cfg.norm_eps))[0]
    return _logits(params, cfg, x), cache


def prefill_step(params, cfg: LMConfig, tokens):
    """Inference prefill: returns (last-position logits (B, 1, V) f32,
    stacked kv cache (k, v)).  The reference slices the last position out
    of ``forward``'s logits; the port projects only that position's hidden
    state onto the vocabulary, the same sums for that row, without the
    (B, S, V) f32 tensor (4.2 GB for two 4096-token llama3.2-1B requests).
    """
    x, cache, _ = _trunk(params, cfg, tokens, True)
    return _logits(params, cfg, x[:, -1:]), cache
