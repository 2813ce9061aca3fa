"""deepseek-7b [arXiv:2401.02954]: 30L d_model=4096 32H (GQA kv=32 = MHA)
d_ff=11008 vocab=102400 — llama architecture."""
from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    name="deepseek-7b",
    kind="lm",
    model=TransformerConfig(
        name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=102400, head_dim=128, qk_norm=False, rope_theta=1e4,
    ),
    reduced_model=TransformerConfig(
        name="deepseek-7b-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=352, vocab=512, head_dim=32, remat="none",
    ),
    shapes=LM_SHAPES,
    source="arXiv:2401.02954",
)
