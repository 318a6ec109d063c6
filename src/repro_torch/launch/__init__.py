"""Launchers: ``serve`` (batched prefill and greedy decode),
``flopcount`` (flop and byte accounting of a function, op by op) and
``mesh`` (device meshes over the local cards or logical devices)."""
