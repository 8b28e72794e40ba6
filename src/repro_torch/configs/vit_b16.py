"""vit-b16: img 224, patch 16, 12L d768 12H d_ff 3072 [arXiv:2010.11929]."""
from repro_torch.configs import ArchSpec, vision_shapes
from repro_torch.models.vit import ViTConfig


def build() -> ArchSpec:
    cfg = ViTConfig(name="vit-b16", img_res=224, patch=16, n_layers=12,
                    d_model=768, n_heads=12, d_ff=3072)
    return ArchSpec("vit_b16", "vision", cfg, vision_shapes(),
                    source="arXiv:2010.11929")


def build_reduced() -> ArchSpec:
    cfg = ViTConfig(name="vit-b16-reduced", img_res=32, patch=8, n_layers=2,
                    d_model=64, n_heads=4, d_ff=128, n_classes=10,
                    remat=False, max_res=64)
    return ArchSpec("vit_b16", "vision", cfg, vision_shapes())
