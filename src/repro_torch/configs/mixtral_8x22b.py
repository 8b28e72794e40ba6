"""mixtral-8x22b: 56L d6144 48H(kv=8) d_ff 16384 vocab 32768, 8 experts
top-2, sliding-window attention [arXiv:2401.04088].  SWA window 4096 ->
sub-quadratic; long_500k decode uses a window-sized ring KV cache."""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer_lm import LMConfig


def build() -> ArchSpec:
    cfg = LMConfig(
        name="mixtral-8x22b",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768, head_dim=128,
        moe=MoEConfig(n_experts=8, top_k=2, norm_topk=False),
        window=4096,
        rope_theta=1000000.0,
    )
    return ArchSpec("mixtral_8x22b", "lm", cfg, lm_shapes(cfg.sub_quadratic),
                    source="arXiv:2401.04088")


def build_reduced() -> ArchSpec:
    cfg = LMConfig(
        name="mixtral-8x22b-reduced",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, d_ff=96,
        vocab=256, head_dim=8,
        moe=MoEConfig(n_experts=4, top_k=2, norm_topk=False),
        window=32, remat=False, attn_chunk=32, q_block=16,
    )
    return ArchSpec("mixtral_8x22b", "lm", cfg, lm_shapes(cfg.sub_quadratic))
