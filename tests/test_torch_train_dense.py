"""The training slice's parity tests of tests/test_torch_train.py in the
pixel decoder's dense mode (one head of 32 over the encoder tokens): the JAX
side on its einsum branch, which is what it runs on the CPU, and the port on
K5's plain versions, forward and backward. A file of its own, so that the
two modes' slow JAX steps run on two test workers."""

import pytest

from test_torch_train import (run_both,  # noqa: F401 - tests run here too
                              test_first_step_losses_and_grad_norm,
                              test_first_step_parameter_gradients,
                              test_parameters_after_three_steps)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return run_both("dense", tmp_path_factory.mktemp("jax"))
