"""qwen3-8b [hf:Qwen/Qwen3-8B]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA."""
from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    name="qwen3-8b",
    kind="lm",
    model=TransformerConfig(
        name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12288, vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    ),
    reduced_model=TransformerConfig(
        name="qwen3-8b-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=384, vocab=512, head_dim=32, qk_norm=True, remat="none",
    ),
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen3-8B",
)
