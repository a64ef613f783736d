"""The port's monolithic training step (``auto_grad: false``) against the JAX
trainer's, on the CPU: ``tests/test_torch_train_step.py``'s comparison (two steps
of the tiny system, the JAX keys' draws; metrics 1e-5 relative, every trainable
leaf and its gradient within 1e-4 of its largest value), in a file of its own so
that the two JAX compilations run side by side."""

from test_torch_train_step import check_train_step_matches_jax


def test_train_step_matches_jax_monolithic():
    check_train_step_matches_jax(auto_grad=False)
