"""Fidelity tools of the port: the host oracle (the exact numpy engine of
urban_tpu_torch.host) against the batched slot-table environment
(counterparts of the JAX package's tools/divergence.py and
tools/replay_failures.py)."""
