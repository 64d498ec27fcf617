"""The benchmark of the PyTorch and CUDA port (``repro_torch``): GCN serving
through its engine, one cell per run. See README.md."""
