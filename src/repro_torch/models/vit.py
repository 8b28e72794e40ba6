"""ViT-B/16 style vision transformer, an encoder-only classifier (port of
``repro.models.vit``).

Parameters keep the reference's layouts, the blocks stacked over layers
(``wq`` (L, d, H, Dh), ``wo`` (L, H, Dh, d), ...).  Attention is the
plain ``layers.chunked_attention``, non-causal, as the reference calls
it (the reference has no kernel switch for this family).  With
``cfg.remat`` each block is recomputed in the backward under autograd.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.params import param_count, spec, tree_unstack

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    dtype: str = "bfloat16"
    remat: bool = True
    max_res: int = 384        # pos-emb table sized for the largest shape

    @property
    def n_patches_max(self) -> int:
        return (self.max_res // self.patch) ** 2

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        return param_count(param_specs(self))


def param_specs(cfg: ViTConfig) -> dict:
    Ln, d, H, ff = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff
    Dh = d // H
    dt = cfg.torch_dtype

    def w(shape, axes, init="fan_in"):
        return spec(shape, axes, dtype=dt, init=init)

    blk = {
        "ln1_w": w((Ln, d), (None, None), "ones"),
        "ln1_b": w((Ln, d), (None, None), "zeros"),
        "ln2_w": w((Ln, d), (None, None), "ones"),
        "ln2_b": w((Ln, d), (None, None), "zeros"),
        "wq": w((Ln, d, H, Dh), (None, "fsdp", "tensor", None)),
        "wk": w((Ln, d, H, Dh), (None, "fsdp", "tensor", None)),
        "wv": w((Ln, d, H, Dh), (None, "fsdp", "tensor", None)),
        "bq": w((Ln, H, Dh), (None, "tensor", None), "zeros"),
        "bk": w((Ln, H, Dh), (None, "tensor", None), "zeros"),
        "bv": w((Ln, H, Dh), (None, "tensor", None), "zeros"),
        "wo": w((Ln, H, Dh, d), (None, "tensor", None, "fsdp")),
        "bo": w((Ln, d), (None, None), "zeros"),
        "w1": w((Ln, d, ff), (None, "fsdp", "tensor")),
        "b1": w((Ln, ff), (None, "tensor"), "zeros"),
        "w2": w((Ln, ff, d), (None, "tensor", "fsdp")),
        "b2": w((Ln, d), (None, None), "zeros"),
    }
    return {
        "patch_embed": w((cfg.patch, cfg.patch, 3, d),
                         (None, None, None, "tensor")),
        "patch_bias": w((d,), ("tensor",), "zeros"),
        "cls_token": w((1, 1, d), (None, None, None), "normal"),
        "pos_embed": w((cfg.n_patches_max + 1, d), (None, None), "normal"),
        "blocks": blk,
        "ln_f_w": w((d,), (None,), "ones"),
        "ln_f_b": w((d,), (None,), "zeros"),
        "head_w": w((d, cfg.n_classes), ("fsdp", "tensor")),
        "head_b": w((cfg.n_classes,), ("tensor",), "zeros"),
    }


def _block(cfg: ViTConfig, p, x):
    B, S, d = x.shape
    H = cfg.n_heads

    def proj(name):
        t = L.mm_f32(h, p["w" + name].reshape(d, -1)).reshape(B, S, H, -1)
        return L.constrain((t + p["b" + name].float()).to(x.dtype),
                           "batch", None, "tensor", None)

    h = L.layer_norm(x, p["ln1_w"], p["ln1_b"])
    q, k, v = proj("q"), proj("k"), proj("v")
    o = L.chunked_attention(q, k, v, causal=False, chunk=min(1024, S))
    # bf16 attention into the weights' dtype, the reference's einsum
    wo = p["wo"].reshape(-1, d)
    h = o.reshape(B, S, -1).to(torch.promote_types(o.dtype, wo.dtype)) @ wo
    x = L.constrain(x + (h.float() + p["bo"].float()).to(x.dtype),
                    "batch", None, None)
    h = L.layer_norm(x, p["ln2_w"], p["ln2_b"])
    return L.constrain(x + L.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"]),
                       "batch", None, None)


def _tokens(params, cfg: ViTConfig, images, patch_bias: bool):
    """Patch embedding (a VALID stride-``patch`` convolution), the CLS
    token and ``pos_embed[:S + 1]``: (tokens (B, S + 1, d), (hp, wp))."""
    B = images.shape[0]
    d, dt = cfg.d_model, cfg.torch_dtype
    x = L.conv_nhwc(images.to(dt), params["patch_embed"], stride=cfg.patch,
                    padding="VALID")
    if patch_bias:
        x = (x.float() + params["patch_bias"].float()).to(dt)
    hp, wp = x.shape[1], x.shape[2]
    S = hp * wp
    x = x.reshape(B, S, d)
    cls = params["cls_token"].to(dt).expand(B, 1, d)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos_embed"][:S + 1].to(dt)[None], (hp, wp)


def _trunk(params, cfg: ViTConfig, x):
    """The blocks and the final LayerNorm."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in tree_unstack(params["blocks"]):
        x = checkpoint(_block, cfg, p, x, use_reentrant=False) if remat \
            else _block(cfg, p, x)
    return L.layer_norm(x, params["ln_f_w"], params["ln_f_b"])


def forward(params, cfg: ViTConfig, images):
    """images (B, H, W, 3) -> logits (B, n_classes) f32."""
    x, _ = _tokens(params, cfg, images, patch_bias=True)
    x = _trunk(params, cfg, x)
    return L.mm_f32(x[:, 0], params["head_w"]) + params["head_b"].float()


def features(params, cfg: ViTConfig, images):
    """Patch-token feature map (B, H/p, W/p, d) for detection heads.  As
    the reference's, it leaves ``patch_bias`` out."""
    x, (hp, wp) = _tokens(params, cfg, images, patch_bias=False)
    x = _trunk(params, cfg, x)
    return x[:, 1:].reshape(x.shape[0], hp, wp, cfg.d_model)


def loss_fn(params, cfg: ViTConfig, batch):
    from repro_torch.models.transformer_lm import softmax_xent
    return softmax_xent(forward(params, cfg, batch["images"]),
                        batch["labels"])
