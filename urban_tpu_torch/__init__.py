"""urban_tpu_torch: the PyTorch and CUDA port of urban_tpu.

The batched environment (torchenv), the SGNN actor-critic (models), the
PPO trainer (rl) and the hand-written Hopper kernels (ops, csrc) beside the
JAX reference package.
The port imports torch and never jax; it shares urban_tpu's host tier
(numpy scenario loading and the exact host engine).
"""

__version__ = '0.1.0'
