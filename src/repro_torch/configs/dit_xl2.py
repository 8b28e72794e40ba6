"""dit-xl2: img_res 256, patch 2, 28L d1152 16H [arXiv:2212.09748]."""
from repro_torch.configs import ArchSpec, diffusion_shapes
from repro_torch.models.dit import DiTConfig


def build() -> ArchSpec:
    cfg = DiTConfig(name="dit-xl2", img_res=256, patch=2, n_layers=28,
                    d_model=1152, n_heads=16)
    return ArchSpec("dit_xl2", "diffusion", cfg, diffusion_shapes(),
                    source="arXiv:2212.09748")


def build_reduced() -> ArchSpec:
    cfg = DiTConfig(name="dit-xl2-reduced", img_res=32, patch=2, n_layers=2,
                    d_model=64, n_heads=4, n_classes=10, remat=False,
                    max_latent=8)
    return ArchSpec("dit_xl2", "diffusion", cfg, diffusion_shapes())
