"""Diffusion Transformer (DiT) with adaLN-Zero conditioning
[arXiv:2212.09748] (port of ``repro.models.dit``).

Operates on VAE latents (img_res/8, 4 channels) given directly; the VAE
is a stub in the reference too.  The train step is the noise-prediction
MSE at a timestep and noise the data supply; serving is DDIM, one step a
call (:func:`ddim_step`), or :func:`sample_with_cache`, which reuses a
noise estimate between refreshes.  Parameters keep the reference's
layouts, the blocks stacked over layers; attention is the plain
``layers.chunked_attention``, as the reference calls it.  With
``cfg.remat`` each block is recomputed in the backward under autograd.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.params import param_count, spec, tree_unstack

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    name: str
    img_res: int                  # pixel resolution of the *default* shape
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    n_classes: int = 1000
    latent_channels: int = 4
    vae_factor: int = 8
    dtype: str = "bfloat16"
    remat: bool = True
    max_latent: int = 128         # pos-emb sized for largest (1024/8)

    @property
    def mlp_ratio(self) -> int:
        return 4

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def latent_res(self, img_res: int) -> int:
        return img_res // self.vae_factor

    def n_tokens(self, img_res: int) -> int:
        return (self.latent_res(img_res) // self.patch) ** 2

    def param_count(self) -> int:
        return param_count(param_specs(self))


def param_specs(cfg: DiTConfig) -> dict:
    Ln, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
    Dh = d // H
    ff = d * cfg.mlp_ratio
    dt = cfg.torch_dtype
    in_dim = cfg.patch * cfg.patch * cfg.latent_channels
    max_tokens = (cfg.max_latent // cfg.patch) ** 2

    def w(shape, axes, init="fan_in"):
        return spec(shape, axes, dtype=dt, init=init)

    blk = {
        "adaln_w": w((Ln, d, 6 * d), (None, "fsdp", "tensor"), "zeros"),
        "adaln_b": w((Ln, 6 * d), (None, "tensor"), "zeros"),
        "wq": w((Ln, d, H, Dh), (None, "fsdp", "tensor", None)),
        "wk": w((Ln, d, H, Dh), (None, "fsdp", "tensor", None)),
        "wv": w((Ln, d, H, Dh), (None, "fsdp", "tensor", None)),
        "wo": w((Ln, H, Dh, d), (None, "tensor", None, "fsdp")),
        "w1": w((Ln, d, ff), (None, "fsdp", "tensor")),
        "b1": w((Ln, ff), (None, "tensor"), "zeros"),
        "w2": w((Ln, ff, d), (None, "tensor", "fsdp")),
        "b2": w((Ln, d), (None, None), "zeros"),
    }
    return {
        "patch_w": w((in_dim, d), (None, "tensor")),
        "patch_b": w((d,), ("tensor",), "zeros"),
        "pos_embed": w((max_tokens, d), (None, None), "normal"),
        "t_mlp1": w((256, d), (None, "tensor")),
        "t_mlp1_b": w((d,), ("tensor",), "zeros"),
        "t_mlp2": w((d, d), ("fsdp", "tensor")),
        "t_mlp2_b": w((d,), ("tensor",), "zeros"),
        "y_embed": w((cfg.n_classes + 1, d), (None, "tensor"), "normal"),
        "blocks": blk,
        "final_adaln_w": w((d, 2 * d), ("fsdp", "tensor"), "zeros"),
        "final_adaln_b": w((2 * d,), ("tensor",), "zeros"),
        "final_ln_w": w((d,), (None,), "ones"),
        "final_w": w((d, in_dim), ("fsdp", None), "zeros"),
        "final_b": w((in_dim,), (None,), "zeros"),
    }


def timestep_embedding(t, dim: int = 256):
    """Sinusoidal embedding (B,) -> (B, dim) f32: [cos, sin] of t times
    ``dim // 2`` frequencies from 1 down to 1/10000."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=f32, device=t.device)
                      / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _plain_ln(x):
    """``layer_norm`` with weight 1 and bias 0 in x's dtype, as the
    reference passes them; in f32."""
    d = x.shape[-1]
    ones = torch.ones((d,), dtype=x.dtype, device=x.device)
    zeros = torch.zeros((d,), dtype=x.dtype, device=x.device)
    return L.layer_norm(x, ones, zeros).float()


def _block(cfg: DiTConfig, p, x, c):
    """x (B, S, d) tokens, c (B, d) conditioning."""
    B, S, d = x.shape
    H = cfg.n_heads
    mod = L.mm_f32(c, p["adaln_w"]) + p["adaln_b"].float()
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _modulate(_plain_ln(x), sh1, sc1).to(x.dtype)

    def proj(w):
        return L.mm_f32(h, w.reshape(d, -1)).reshape(B, S, H, -1) \
            .to(x.dtype)

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    o = L.chunked_attention(q, k, v, causal=False, chunk=min(1024, S))
    # bf16 attention into the weights' dtype, the reference's einsum
    wo = p["wo"].reshape(-1, d)
    o = o.reshape(B, S, -1).to(torch.promote_types(o.dtype, wo.dtype)) @ wo
    x = L.constrain(x + (g1[:, None] * o.float()).to(x.dtype),
                    "batch", None, None)
    h = _modulate(_plain_ln(x), sh2, sc2).to(x.dtype)
    h = L.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"])
    return L.constrain(x + (g2[:, None] * h.float()).to(x.dtype),
                       "batch", None, None)


def patchify(latents, patch: int):
    """(B, H, W, C) -> ((B, hp * wp, patch * patch * C), (hp, wp))."""
    B, Hh, Ww, C = latents.shape
    hp, wp = Hh // patch, Ww // patch
    x = latents.reshape(B, hp, patch, wp, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, hp * wp, patch * patch * C)
    return x, (hp, wp)


def unpatchify(x, hw, patch: int, channels: int):
    """The inverse of :func:`patchify`."""
    B = x.shape[0]
    hp, wp = hw
    x = x.reshape(B, hp, wp, patch, patch, channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, hp * patch, wp * patch,
                                               channels)


def forward(params, cfg: DiTConfig, latents, t, y):
    """Noise prediction eps_theta(x_t, t, y): latents (B, h, w, C), t (B,)
    and y (B,) int -> (B, h, w, C) f32.  Labels index ``y_embed``'s
    n_classes + 1 rows (the last the null class) as the reference's
    ``.at[y].get(mode="clip")`` (:func:`layers.take_clip`)."""
    dt = cfg.torch_dtype
    x, hw = patchify(latents.to(dt), cfg.patch)
    S = x.shape[1]
    x = L.mm_f32(x, params["patch_w"]) + params["patch_b"].float()
    x = x.to(dt) + params["pos_embed"][:S].to(dt)[None]
    # the timestep MLP in f32 (exact products: TF32 is off in the port)
    temb = timestep_embedding(t)
    temb = temb @ params["t_mlp1"].float() + params["t_mlp1_b"].float()
    temb = F.silu(temb)
    temb = temb @ params["t_mlp2"].float() + params["t_mlp2_b"].float()
    yemb = L.take_clip(params["y_embed"], y).float()
    c = (temb + yemb).to(dt)

    remat = cfg.remat and torch.is_grad_enabled()
    for p in tree_unstack(params["blocks"]):
        x = checkpoint(_block, cfg, p, x, c, use_reentrant=False) if remat \
            else _block(cfg, p, x, c)
    mod = L.mm_f32(c, params["final_adaln_w"]) \
        + params["final_adaln_b"].float()
    sh, sc = mod.chunk(2, dim=-1)
    x = _modulate(_plain_ln(x), sh, sc)
    x = L.mm_f32(x.to(dt), params["final_w"]) + params["final_b"].float()
    return unpatchify(x.float(), hw, cfg.patch, cfg.latent_channels)


# DDPM cosine schedule ------------------------------------------------------
def alpha_bar(t, T: int = 1000):
    s = 0.008
    tt = t.float() / T
    return torch.cos((tt + s) / (1 + s) * math.pi / 2) ** 2


def loss_fn(params, cfg: DiTConfig, batch):
    """batch: latents (clean), t (B,), noise (B, h, w, C), labels (B,)."""
    x0, t, eps, y = (batch["latents"], batch["t"], batch["noise"],
                     batch["labels"])
    ab = alpha_bar(t)[:, None, None, None]
    xt = torch.sqrt(ab) * x0.float() + torch.sqrt(1 - ab) * eps.float()
    pred = forward(params, cfg, xt, t, y)
    return torch.mean(torch.square(pred - eps.float()))


def ddim_update(xt, eps, t, t_prev):
    """Deterministic DDIM update x_t -> x_{t_prev} given a noise
    estimate."""
    ab_t = alpha_bar(t)[:, None, None, None]
    ab_p = alpha_bar(t_prev)[:, None, None, None]
    x0 = (xt.float() - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    return torch.sqrt(ab_p) * x0 + torch.sqrt(1 - ab_p) * eps


def ddim_step(params, cfg: DiTConfig, xt, t, t_prev, y):
    """One DDIM step (a fresh forward)."""
    eps = forward(params, cfg, xt, t, y)
    return ddim_update(xt, eps, t, t_prev)


def sample_with_cache(params, cfg: DiTConfig, x, timesteps, y,
                      refresh_every: int = 2):
    """Step-cached sampling, BiSwift's reuse pipeline (3) mapped to
    diffusion serving: the noise estimate is refreshed by a forward every
    ``refresh_every`` steps and reused in between, which cuts the
    sampler's forwards to ceil(steps / refresh_every).

    timesteps: a decreasing sequence of steps + 1 ints; returns the final
    x (f32).
    """
    eps = None
    B = x.shape[0]
    for i in range(len(timesteps) - 1):
        t = torch.full((B,), int(timesteps[i]), dtype=torch.int32,
                       device=x.device)
        tp = torch.full((B,), int(timesteps[i + 1]), dtype=torch.int32,
                        device=x.device)
        if eps is None or i % refresh_every == 0:
            eps = forward(params, cfg, x, t, y)
        x = ddim_update(x, eps, t, tp)
    return x
