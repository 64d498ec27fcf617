from repro_torch.roofline.analysis import (  # noqa: F401
    HW,
    collective_bytes,
    roofline_terms,
)
