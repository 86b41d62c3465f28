"""urban_tpu_torch: the PyTorch and CUDA port of urban_tpu.

The batched environment (torchenv), the SGNN actor-critic (models), the
PPO trainer (rl) and the hand-written Hopper kernels (ops, csrc) beside the
JAX reference package; and the reference's own API on the exact host
environment: the agent (agents), the ``train`` and ``eval`` CLIs and
their utilities (utils).
The port imports torch and never jax, and nothing of urban_tpu: the numpy
host tier it needs (scenario loading, the plan tables, the exact host
geometry and environment, the host sampler, the baselines, the run
configuration) is its own copy in ``host``.
"""

__version__ = '0.1.0'
