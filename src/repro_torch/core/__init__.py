"""AWB-GCN core on PyTorch: formats, schedules, SpMM, executor, GCN.

Import the submodules directly (``from repro_torch.core import schedule``);
this package imports nothing on its own, so loading one module never pulls
in the others.
"""
