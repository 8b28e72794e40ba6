"""ConvNeXt-B: depths 3-3-27-3, dims 128-256-512-1024 [arXiv:2201.03545]
(port of ``repro.models.convnext``).

Block: 7x7 depthwise conv -> LayerNorm -> 1x1 (4x expand) -> GELU -> 1x1
-> LayerScale -> residual.  A stage's blocks are stacked on a leading
axis, as in the reference; each block is recomputed in the backward
(``torch.utils.checkpoint``) under autograd, as the reference's
``jax.checkpoint`` of its scan body.  ``gamma`` is made by the ``"ones"``
rule, which ignores ``scale=ls_init`` in both packages: it starts at 1.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.params import param_count, spec, tree_unstack

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    name: str
    depths: tuple[int, int, int, int] = (3, 3, 27, 3)
    dims: tuple[int, int, int, int] = (128, 256, 512, 1024)
    n_classes: int = 1000
    dtype: str = "bfloat16"
    ls_init: float = 1e-6

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        return param_count(param_specs(self))


def param_specs(cfg: ConvNeXtConfig) -> dict:
    dt = cfg.torch_dtype
    p = {
        "stem_conv": spec((4, 4, 3, cfg.dims[0]), (None, None, None, "tensor"),
                          dtype=dt, init="fan_in"),
        "stem_ln_w": spec((cfg.dims[0],), (None,), dtype=dt, init="ones"),
        "stem_ln_b": spec((cfg.dims[0],), (None,), dtype=dt, init="zeros"),
        "head_w": spec((cfg.dims[-1], cfg.n_classes), ("fsdp", "tensor"),
                       dtype=dt, init="fan_in"),
        "head_b": spec((cfg.n_classes,), ("tensor",), dtype=dt, init="zeros"),
        "final_ln_w": spec((cfg.dims[-1],), (None,), dtype=dt, init="ones"),
        "final_ln_b": spec((cfg.dims[-1],), (None,), dtype=dt, init="zeros"),
    }
    for si, (n, d) in enumerate(zip(cfg.depths, cfg.dims)):
        if si > 0:
            prev = cfg.dims[si - 1]
            p[f"down{si}_ln_w"] = spec((prev,), (None,), dtype=dt,
                                       init="ones")
            p[f"down{si}_ln_b"] = spec((prev,), (None,), dtype=dt,
                                       init="zeros")
            p[f"down{si}_conv"] = spec((2, 2, prev, d),
                                       (None, None, None, "tensor"), dtype=dt,
                                       init="fan_in")
        p[f"s{si}"] = {
            "dw": spec((n, 7, 7, 1, d), (None, None, None, None, "tensor"),
                       dtype=dt, init="fan_in"),
            "ln_w": spec((n, d), (None, None), dtype=dt, init="ones"),
            "ln_b": spec((n, d), (None, None), dtype=dt, init="zeros"),
            "w1": spec((n, d, 4 * d), (None, "fsdp", "tensor"), dtype=dt,
                       init="fan_in"),
            "b1": spec((n, 4 * d), (None, "tensor"), dtype=dt, init="zeros"),
            "w2": spec((n, 4 * d, d), (None, "tensor", "fsdp"), dtype=dt,
                       init="fan_in"),
            "b2": spec((n, d), (None, None), dtype=dt, init="zeros"),
            "gamma": spec((n, d), (None, None), dtype=dt, init="ones",
                          scale=cfg.ls_init),
        }
    return p


def _block(x, p):
    d = x.shape[-1]
    h = L.conv_nhwc(x, p["dw"], groups=d)
    h = L.layer_norm(h, p["ln_w"], p["ln_b"])
    h = L.mm_f32(h, p["w1"])
    h = F.gelu(h + p["b1"].float(), approximate="tanh").to(x.dtype)
    h = h @ p["w2"]                         # the reference's x-dtype result
    h = (h.float() + p["b2"].float()) * p["gamma"].float()
    return L.constrain(x + h.to(x.dtype), "batch", None, None, None)


def forward(params, cfg: ConvNeXtConfig, images):
    """images (B, H, W, 3) -> logits (B, n_classes) f32."""
    dt = cfg.torch_dtype
    remat = torch.is_grad_enabled()
    x = L.conv_nhwc(images.to(dt), params["stem_conv"], stride=4,
                    padding="VALID")
    x = L.layer_norm(x, params["stem_ln_w"], params["stem_ln_b"])
    for si in range(4):
        if si > 0:
            x = L.layer_norm(x, params[f"down{si}_ln_w"],
                             params[f"down{si}_ln_b"])
            x = L.conv_nhwc(x, params[f"down{si}_conv"], stride=2,
                            padding="VALID")
        for p in tree_unstack(params[f"s{si}"]):
            x = checkpoint(_block, x, p, use_reentrant=False) if remat \
                else _block(x, p)
    x = x.float().mean(dim=(1, 2)).to(dt)
    x = L.layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    return L.mm_f32(x, params["head_w"]) + params["head_b"].float()


def loss_fn(params, cfg: ConvNeXtConfig, batch):
    from repro_torch.models.transformer_lm import softmax_xent
    return softmax_xent(forward(params, cfg, batch["images"]),
                        batch["labels"])
