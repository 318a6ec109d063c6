"""Launchers: ``serve`` (batched prefill and greedy decode), ``train``
(the train step and a single-device training loop), ``flopcount`` (flop
and byte accounting of a function, op by op), ``mesh`` (device meshes
over the local cards or logical devices), ``dryrun`` (every cell traced
on ``meta`` over the production meshes) and ``hlo_stats`` (the dry
run's collective and memory statistics)."""
