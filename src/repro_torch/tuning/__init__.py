"""Schedule and executor caches keyed by graph fingerprint."""
