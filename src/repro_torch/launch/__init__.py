"""Launchers: ``serve`` (batched prefill and greedy decode) and
``flopcount`` (flop and byte accounting of a function, op by op)."""
