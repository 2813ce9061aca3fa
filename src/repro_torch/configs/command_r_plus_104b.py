"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01 family]: 64L
d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 — GQA, no-bias."""
from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    name="command-r-plus-104b",
    kind="lm",
    model=TransformerConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
        n_kv_heads=8, d_ff=33792, vocab=256000, head_dim=128, qk_norm=False,
        rope_theta=1e4,
    ),
    reduced_model=TransformerConfig(
        name="command-r-smoke", n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=32, remat="none",
    ),
    shapes=LM_SHAPES,
    source="hf:CohereForAI/c4ai-command-r-plus",
)
