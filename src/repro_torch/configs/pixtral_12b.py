"""pixtral-12b — VLM: pixtral-ViT frontend (STUB per assignment) +
mistral-nemo decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified] 40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    segments=((("attn",), 40),),
    rope=True,
    rope_theta=1e6,
    norm="rmsnorm",
    activation="silu",
    glu=True,
    frontend="vision",
)
