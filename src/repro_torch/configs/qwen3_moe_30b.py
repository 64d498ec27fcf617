"""qwen3-moe-30b-a3b — MoE, 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (kv=4) expert d_ff=768
vocab=151936.

AWB-GCN applicability: PRIMARY and the most representative assigned arch —
128 experts, power-law routing; hillclimb cell (EXPERIMENTS.md §Perf).
"""
from repro_torch.models.transformer import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    qk_norm=True,
    d_ff=768,                # per-expert hidden
    vocab=151936,
    segments=((("attn_moe",), 48),),
    rope=True,
    rope_theta=1e6,
    norm="rmsnorm",
    activation="silu",
    glu=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
)
