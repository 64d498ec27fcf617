"""LM substrate: the assigned architectures as PyTorch modules.

The names the JAX package's ``repro.models`` exports resolve from
``models.transformer`` on first access (PEP 562); ``import
repro_torch.models`` imports no submodule.
"""

from repro_torch.lazyexports import lazy_exports

_EXPORTS = {name: "repro_torch.models.transformer" for name in (
    "ModelConfig",
    "MoEConfig",
    "EncoderConfig",
    "init_params",
    "model_forward",
    "init_cache",
    "prefill",
    "decode_step",
    "param_specs",
    "count_params",
)}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS, globals())
