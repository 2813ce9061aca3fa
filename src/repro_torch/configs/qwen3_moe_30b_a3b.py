"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d_model=2048 32H (GQA
kv=4) expert d_ff=768 vocab=151936, MoE 128 experts top-8."""
from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    name="qwen3-moe-30b-a3b",
    kind="lm",
    model=TransformerConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=0, vocab=151936, head_dim=128, qk_norm=True,
        rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert_ff=768),
    ),
    reduced_model=TransformerConfig(
        name="qwen3-moe-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab=512, head_dim=32, qk_norm=True, remat="none",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64),
    ),
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen3-30B-A3B",
)
