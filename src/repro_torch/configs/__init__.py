"""Architecture registry (port of ``repro.configs``): the ten zoo
architectures; the paper's own edge config is ``configs.biswift_edge``.

Each ``configs/<id>.py`` exposes ``build() -> ArchSpec`` with the
reference's full configuration and ``build_reduced() -> ArchSpec`` for the
CPU parity tests: four decoder LMs (llama3.2-1B, chatglm3-6B,
qwen2-moe-a2.7B, mixtral-8x22B), two diffusion transformers (DiT-XL/2,
DiT-B/2) and four vision classifiers (ResNet-152, ResNet-50, ConvNeXt-B,
ViT-B/16).  Select one with ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str             # train | prefill | decode | sample | infer
    batch: int
    seq_len: int = 0      # LM shapes
    img_res: int = 0      # vision / diffusion shapes
    steps: int = 1        # diffusion sampler steps
    grad_accum: int = 1   # microbatches per step (activation memory control)
    skip: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str           # lm | diffusion | vision
    cfg: Any
    shapes: dict[str, ShapeCase]
    source: str = ""


def lm_shapes(sub_quadratic: bool) -> dict[str, ShapeCase]:
    return {
        "train_4k": ShapeCase("train_4k", "train", batch=256, seq_len=4096,
                              grad_accum=8),
        "prefill_32k": ShapeCase("prefill_32k", "prefill", batch=32,
                                 seq_len=32768),
        "decode_32k": ShapeCase("decode_32k", "decode", batch=128,
                                seq_len=32768),
        "long_500k": ShapeCase(
            "long_500k", "decode", batch=1, seq_len=524288,
            skip=None if sub_quadratic else
            "pure full-attention arch: long_500k needs sub-quadratic "
            "attention (DESIGN.md §4)"),
    }


def diffusion_shapes() -> dict[str, ShapeCase]:
    return {
        "train_256": ShapeCase("train_256", "train", batch=256, img_res=256,
                               steps=1000),
        "gen_1024": ShapeCase("gen_1024", "sample", batch=4, img_res=1024,
                              steps=50),
        "gen_fast": ShapeCase("gen_fast", "sample", batch=16, img_res=512,
                              steps=4),
        "train_1024": ShapeCase("train_1024", "train", batch=32, img_res=1024,
                                steps=1000),
    }


def vision_shapes() -> dict[str, ShapeCase]:
    return {
        "cls_224": ShapeCase("cls_224", "train", batch=256, img_res=224),
        "cls_384": ShapeCase("cls_384", "train", batch=64, img_res=384),
        "serve_b1": ShapeCase("serve_b1", "infer", batch=1, img_res=224),
        "serve_b128": ShapeCase("serve_b128", "infer", batch=128, img_res=224),
    }


ARCH_IDS = [
    "llama3_2_1b", "chatglm3_6b", "qwen2_moe_a2_7b", "mixtral_8x22b",
    "dit_xl2", "dit_b2",
    "resnet_152", "resnet_50", "convnext_b", "vit_b16",
]

# dashes in the public ids map to underscores in module names
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({"llama3.2-1b": "llama3_2_1b", "qwen2-moe-a2.7b":
                "qwen2_moe_a2_7b", "mixtral-8x22b": "mixtral_8x22b",
                "dit-xl2": "dit_xl2", "dit-b2": "dit_b2",
                "resnet-152": "resnet_152", "resnet-50": "resnet_50",
                "convnext-b": "convnext_b", "vit-b16": "vit_b16",
                "chatglm3-6b": "chatglm3_6b"})


def get_arch(arch_id: str, reduced: bool = False) -> ArchSpec:
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.build_reduced() if reduced else mod.build()


def all_cells():
    """Yield every (arch_id, shape_name, skip_reason_or_None)."""
    for a in ARCH_IDS:
        spec = get_arch(a)
        for s in spec.shapes.values():
            yield a, s.name, s.skip
