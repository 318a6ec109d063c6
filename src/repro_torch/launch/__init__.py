"""Launchers: ``serve`` (batched prefill and greedy decode)."""
