"""qwen2-moe-a2.7b: 24L d2048 16H(kv=16) expert_ff 1408 vocab 151936,
60 routed experts top-4 + 4 shared (fused shared width 5632)
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer_lm import LMConfig


def build() -> ArchSpec:
    cfg = LMConfig(
        name="qwen2-moe-a2.7b",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=151936,
        moe=MoEConfig(n_experts=60, top_k=4, norm_topk=True),
        d_ff_shared=5632,
        qkv_bias=True,
        rope_theta=1000000.0,
    )
    return ArchSpec("qwen2_moe_a2_7b", "lm", cfg, lm_shapes(cfg.sub_quadratic),
                    source="hf:Qwen/Qwen1.5-MoE-A2.7B")


def build_reduced() -> ArchSpec:
    cfg = LMConfig(
        name="qwen2-moe-a2.7b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab=256, moe=MoEConfig(n_experts=8, top_k=2, norm_topk=True),
        d_ff_shared=64, qkv_bias=True, remat=False, attn_chunk=32,
        q_block=32,
    )
    return ArchSpec("qwen2_moe_a2_7b", "lm", cfg, lm_shapes(cfg.sub_quadratic))
