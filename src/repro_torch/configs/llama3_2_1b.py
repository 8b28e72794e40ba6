"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer_lm import LMConfig


def build() -> ArchSpec:
    cfg = LMConfig(
        name="llama3.2-1b",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=128256,
        rope_theta=500000.0,
    )
    return ArchSpec("llama3_2_1b", "lm", cfg, lm_shapes(cfg.sub_quadratic),
                    source="hf:meta-llama/Llama-3.2-1B")


def build_reduced() -> ArchSpec:
    cfg = LMConfig(
        name="llama3.2-1b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, rope_theta=500000.0, remat=False, attn_chunk=32,
        q_block=32,
    )
    return ArchSpec("llama3_2_1b", "lm", cfg, lm_shapes(cfg.sub_quadratic))
