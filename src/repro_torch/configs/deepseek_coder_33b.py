"""deepseek-coder-33b — llama-architecture dense GQA transformer.
[arXiv:2401.14196; hf] 62L d_model=7168 56H (kv=8) d_ff=19200 vocab=32256."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=19200,
    vocab=32256,
    segments=((("attn",), 62),),
    rope=True,
    rope_theta=1e5,
    norm="rmsnorm",
    activation="silu",
    glu=True,
)
