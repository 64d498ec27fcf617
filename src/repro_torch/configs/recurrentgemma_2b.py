"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 2:1.
[arXiv:2402.19427; hf] 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, window=2048. Pattern: (rec, rec, attn) × 8 + (rec, rec)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    segments=((("rglru", "rglru", "local"), 8), (("rglru", "rglru"), 1)),
    rope=True,
    rope_theta=1e4,
    norm="rmsnorm",
    activation="gelu",   # GeGLU
    glu=True,
    window=2048,
    d_rnn=2560,
)
