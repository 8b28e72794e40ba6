"""dit-b2: img_res 256, patch 2, 12L d768 12H [arXiv:2212.09748]."""
from repro_torch.configs import ArchSpec, diffusion_shapes
from repro_torch.models.dit import DiTConfig


def build() -> ArchSpec:
    cfg = DiTConfig(name="dit-b2", img_res=256, patch=2, n_layers=12,
                    d_model=768, n_heads=12)
    return ArchSpec("dit_b2", "diffusion", cfg, diffusion_shapes(),
                    source="arXiv:2212.09748")


def build_reduced() -> ArchSpec:
    cfg = DiTConfig(name="dit-b2-reduced", img_res=32, patch=2, n_layers=2,
                    d_model=48, n_heads=4, n_classes=10, remat=False,
                    max_latent=8)
    return ArchSpec("dit_b2", "diffusion", cfg, diffusion_shapes())
