"""rwkv6-3b — RWKV-6 "Finch" 3B: attention-free, data-dependent decay.
[arXiv:2404.05892; hf] 32L d_model=2560 d_ff=8960 vocab=65536."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # 2560 / 64-dim wkv heads
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab=65536,
    segments=((("rwkv",), 32),),
    rope=False,
    norm="layernorm",    # RWKV uses LayerNorm
    glu=False,
    activation="relu2",  # ChannelMix uses squared ReLU internally
)
