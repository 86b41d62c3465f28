"""The port's PPO trainer loop with the MLP state encoder (the round-5
SGNN-vs-MLP ablation's trunk) against urban_tpu.rl.train_tpu.TPUTrainer
(encoder='mlp'), across iterations: the lockstep of
tests/test_torch_trainer_lockstep.py (HLG at the trainer's caps, the
learning-parity recipe's flags, the JAX trainer's initial draw converted,
JAX's key chain's uniforms served to the port's draw function) with the
same checks and tolerances. The tier-1 variant runs one iteration without
its eval, then the second collect; the slow one two full iterations and a
third collect.
"""
import pytest

from test_torch_trainer_lockstep import run_lockstep


@pytest.mark.parametrize('iterations,do_eval', [
    (1, False), pytest.param(2, True, marks=pytest.mark.slow)])
def test_mlp_trainer_loop_matches_tpu_trainer_across_iterations(
        iterations, do_eval, tmp_path, monkeypatch):
    run_lockstep(iterations, do_eval, tmp_path, monkeypatch, encoder='mlp')
