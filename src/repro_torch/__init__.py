"""AWB-GCN on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The layout mirrors the JAX package module for module (``core/``,
``graphs/``, ``kernels/``, ``tuning/``), so every function has a
counterpart of the same name. Host-side artifacts (COO arrays, schedules,
fingerprints) are bit-identical to the JAX package's; the Pallas SpMM
kernel is replaced by a hand-written Hopper kernel in
``kernels/csrc/spmm_balanced.cu``.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device they raise (``device.resolve_device``).
"""

from repro_torch.device import resolve_device  # noqa: F401
