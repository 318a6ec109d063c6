"""Data pipeline (the JAX package's ``data``)."""
from .pipeline import SyntheticTokens, make_batch_specs

__all__ = ["SyntheticTokens", "make_batch_specs"]
