"""convnext-b: depths 3-3-27-3, dims 128-256-512-1024 [arXiv:2201.03545]."""
from repro_torch.configs import ArchSpec, vision_shapes
from repro_torch.models.convnext import ConvNeXtConfig


def build() -> ArchSpec:
    cfg = ConvNeXtConfig(name="convnext-b", depths=(3, 3, 27, 3),
                         dims=(128, 256, 512, 1024))
    return ArchSpec("convnext_b", "vision", cfg, vision_shapes(),
                    source="arXiv:2201.03545")


def build_reduced() -> ArchSpec:
    cfg = ConvNeXtConfig(name="convnext-b-reduced", depths=(1, 1, 2, 1),
                         dims=(16, 32, 64, 128), n_classes=10)
    return ArchSpec("convnext_b", "vision", cfg, vision_shapes())
