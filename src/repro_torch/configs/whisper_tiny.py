"""whisper-tiny — encoder-decoder; conv frontend is a STUB per assignment
(input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified] 4L d_model=384 6H d_ff=1536 vocab=51865.

Deviation note (DESIGN.md): learned absolute positions replaced by RoPE —
a positional-encoding substitute that keeps the backbone's shapes exact.
"""
from repro_torch.models.transformer import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers; encoder configured below
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab=51865,
    segments=((("xattn",), 4),),
    rope=True,
    norm="layernorm",
    activation="gelu",
    glu=False,
    encoder=EncoderConfig(n_layers=4, max_source=1500),
    frontend="audio",
    tie_embeddings=True,
)
