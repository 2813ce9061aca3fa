"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (kv=16 = MHA) expert d_ff=1408 vocab=163840, MoE 64 experts top-6."""
from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b",
    kind="lm",
    model=TransformerConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=0, vocab=163840, head_dim=128, qk_norm=False,
        rope_theta=5e4,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408),
    ),
    reduced_model=TransformerConfig(
        name="moonshot-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=512, head_dim=32, remat="none",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=96),
    ),
    shapes=LM_SHAPES,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
