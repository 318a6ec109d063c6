"""Data pipeline (the JAX package's ``data``; ``make_batch_specs``, the
dry-run's input stand-ins, comes with ``launch/dryrun.py``)."""
from .pipeline import SyntheticTokens

__all__ = ["SyntheticTokens"]
