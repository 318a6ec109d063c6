"""Launchers: ``serve`` (batched prefill and greedy decode), ``train``
(the train step and a single-device training loop), ``flopcount`` (flop
and byte accounting of a function, op by op) and ``mesh`` (device meshes
over the local cards or logical devices)."""
