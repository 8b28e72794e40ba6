"""chatglm3-6b: 28L d4096 32H GQA(kv=2) d_ff 13696 vocab 65024; 2d RoPE
[arXiv:2406.12793; hf].  GLM's "2d rope" rotates half of each head dim."""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer_lm import LMConfig


def build() -> ArchSpec:
    cfg = LMConfig(
        name="chatglm3-6b",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=65024,
        rope_fraction=0.5, rope_theta=10000.0,
    )
    return ArchSpec("chatglm3_6b", "lm", cfg, lm_shapes(cfg.sub_quadratic),
                    source="arXiv:2406.12793")


def build_reduced() -> ArchSpec:
    cfg = LMConfig(
        name="chatglm3-6b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=256, rope_fraction=0.5, rope_theta=10000.0, remat=False,
        attn_chunk=32, q_block=32,
    )
    return ArchSpec("chatglm3_6b", "lm", cfg, lm_shapes(cfg.sub_quadratic))
