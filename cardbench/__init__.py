"""The benchmark of the PyTorch and CUDA port (``repro_torch``): models
served through the port's engines, one cell per run, each configuration
of a model family of its own (``families/``). See README.md."""
