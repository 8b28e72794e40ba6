"""resnet-50: depths 3-4-6-3, width 64, bottleneck [arXiv:1512.03385]."""
from repro_torch.configs import ArchSpec, vision_shapes
from repro_torch.models.resnet import ResNetConfig


def build() -> ArchSpec:
    cfg = ResNetConfig(name="resnet-50", depths=(3, 4, 6, 3), width=64)
    return ArchSpec("resnet_50", "vision", cfg, vision_shapes(),
                    source="arXiv:1512.03385")


def build_reduced() -> ArchSpec:
    cfg = ResNetConfig(name="resnet-50-reduced", depths=(1, 1, 2, 1),
                       width=8, n_classes=10)
    return ArchSpec("resnet_50", "vision", cfg, vision_shapes())
