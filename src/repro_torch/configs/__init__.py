"""Architecture registry (port of ``repro.configs``, the decoder-LM part).

Each ``configs/<id>.py`` exposes ``build() -> ArchSpec`` with the
reference's full configuration and ``build_reduced() -> ArchSpec`` for the
CPU parity tests.  The four decoder LMs are ported (llama3.2-1B,
chatglm3-6B, qwen2-moe-a2.7B, mixtral-8x22B); the vision and diffusion
ids raise ``NotImplementedError`` until their slice (ROADMAP.md queue 3).
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


ARCH_IDS = [
    "llama3_2_1b", "chatglm3_6b", "qwen2_moe_a2_7b", "mixtral_8x22b",
    "dit_xl2", "dit_b2",
    "resnet_152", "resnet_50", "convnext_b", "vit_b16",
]
PORTED = ("llama3_2_1b", "chatglm3_6b", "qwen2_moe_a2_7b", "mixtral_8x22b")

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
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet (ROADMAP.md queue 3); ported: "
            f"{', '.join(PORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.build_reduced() if reduced else mod.build()
