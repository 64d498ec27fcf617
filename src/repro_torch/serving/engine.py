"""The transformer ``ServeEngine``'s historical import path.

``repro_torch.serving`` is the GCN serving stack; the transformer
prefill/decode engine lives at ``repro_torch.models.transformer_serve`` and
is re-exported here, as ``repro.serving.engine`` does.
"""

from __future__ import annotations

from repro_torch.models.transformer_serve import ServeEngine  # noqa: F401
