"""Weights carried between psalm_tpu and psalm_tpu_torch.

``jax_to_torch_state_dict`` inverts ``convert_psalm_checkpoint`` exactly
(a layout change, so equality is bit for bit), and the port's parameter
names are the released checkpoint's keys, so it loads a released-format
state dict as it is.
"""

import numpy as np
import jax
import torch

from test_convert import synthetic_torch_sd

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.models.psalm import PSALM


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_round_trip_through_jax_layout():
    cfg = tiny_test_config()
    sd = synthetic_torch_sd(cfg, np.random.default_rng(0))
    variables = convert_psalm_checkpoint(sd, cfg)
    back = jax_to_torch_state_dict(variables, cfg)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    want, got = _flat(variables), _flat(convert_psalm_checkpoint(back, cfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_loads_released_layout_directly():
    cfg = tiny_test_config()
    sd = synthetic_torch_sd(cfg, np.random.default_rng(1))
    model = PSALM(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    state = model.state_dict()
    assert set(state) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
