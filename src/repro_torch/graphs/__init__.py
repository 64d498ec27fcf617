"""Synthetic graph datasets calibrated to the paper's Table I."""
