"""qwen2-0.5b — small dense GQA transformer, tied embeddings, QKV bias.
[arXiv:2407.10671; hf] 24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab=151936,
    segments=((("attn",), 24),),
    qkv_bias=True,
    rope=True,
    rope_theta=1e6,
    norm="rmsnorm",
    activation="silu",
    glu=True,
    tie_embeddings=True,
)
