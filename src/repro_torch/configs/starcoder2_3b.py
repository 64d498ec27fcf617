"""starcoder2-3b — dense GQA transformer, LayerNorm + bias + GeLU MLP + RoPE.
[arXiv:2402.19173; hf] 30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab=49152,
    segments=((("attn",), 30),),
    qkv_bias=True,
    rope=True,
    rope_theta=1e5,
    norm="layernorm",
    activation="gelu",
    glu=False,
)
