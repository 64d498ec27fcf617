"""Input pipelines of the port: ``tokens``, the deterministic, resumable
synthetic token stream (numpy only, batch for batch the JAX package's)."""
from repro_torch.data.tokens import TokenPipeline, TokenPipelineState  # noqa: F401
