"""granite-moe-3b-a800m — MoE, 40 experts top-8 (granite-3.0-3b-a800m).
[hf:ibm-granite; hf] 32L d_model=1536 24H (kv=8) expert d_ff=512 vocab=49155.

AWB-GCN applicability: PRIMARY — router histograms are power-law; the AWB
placement balancer (core/moe_balance.py) drives expert-parallel dispatch.
"""
from repro_torch.models.transformer import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,               # per-expert hidden
    vocab=49155,
    segments=((("attn_moe",), 32),),
    rope=True,
    rope_theta=1e4,
    norm="rmsnorm",
    activation="silu",
    glu=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
)
