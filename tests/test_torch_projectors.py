"""The ``linear`` and ``mlpNx_gelu`` projectors and ``build_projector``
against psalm_tpu on the CPU, in f32.

Each JAX projector's own flax init gives the weights; ``checkpoint/
from_jax.py`` carries them to the port (``fc`` -> ``model.mm_projector``,
``fc_i`` -> ``model.mm_projector.{2 i}``). These projectors map res5
without the stride-2 block, so a 64^2 image gives (64/32)^2 image tokens;
JAX's PSALM runs end to end when the batch is spliced with that many, and
the port's forward is held to it there.

Tolerances: a projector alone, 1e-5 of the output's largest magnitude (the
same f32 products, GELU through erf on both sides); the tiny PSALM forward
1e-3 of the largest magnitude (tests/test_torch_slice.py's).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_modules import assert_close_rel, load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.data.constants import (CLS_TOKEN_INDEX, IMAGE_TOKEN_INDEX,
                                      SEG_TOKEN_INDEX)
from psalm_tpu.data.splicer import splice
from psalm_tpu.models.projector import build_projector as jbuild_projector
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu_torch.checkpoint import from_jax
from psalm_tpu_torch.config import ProjectorConfig
from psalm_tpu_torch.models import projector
from psalm_tpu_torch.models.psalm import PSALM

torch.backends.cuda.matmul.allow_tf32 = False

TYPES = ("linear", "mlp2x_gelu", "mlp3x_gelu")


def _jax_projector(ptype, input_dim=16, out_dim=8, seed=0):
    """(flax params of JAX's projector of ``ptype``, its output on a random
    res5 [2, 4, 6, input_dim], that res5)."""
    from psalm_tpu.config import ProjectorConfig as JProjectorConfig
    cfg = JProjectorConfig(projector_type=ptype, input_dim=input_dim,
                           out_dim=out_dim)
    m = jbuild_projector(cfg)
    x = np.random.default_rng(seed).standard_normal(
        (2, 4, 6, input_dim)).astype(np.float32)
    variables = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    # nonzero biases, so that each bias is carried to its place
    params = jax.tree.map(lambda a: a + 0.1 * jnp.arange(a.size).reshape(
        a.shape) / a.size, variables["params"])
    return params, m.apply({"params": params}, jnp.asarray(x)), x


def _port_state(params):
    sd = {}
    from_jax._projector(sd, params, {})
    pre = "model.mm_projector"
    return {k[len(pre) + 1:]: v for k, v in sd.items()}


@pytest.mark.parametrize("ptype", TYPES)
def test_projector_matches_jax(ptype):
    params, want, x = _jax_projector(ptype)
    m = projector.build_projector(ProjectorConfig(projector_type=ptype,
                                                  input_dim=16, out_dim=8))
    load_port(m, _port_state(params))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (2, 24, 8)
    assert_close_rel(got.numpy(), want, rel=1e-5)


def test_build_projector_names_the_reference_parameters():
    def names(ptype):
        return sorted(n for n, _ in projector.build_projector(ProjectorConfig(
            projector_type=ptype, input_dim=16, out_dim=8),
            device="meta").named_parameters())

    assert names("linear") == ["bias", "weight"]
    assert names("mlp3x_gelu") == [f"{i}.{p}" for i in (0, 2, 4)
                                   for p in ("bias", "weight")]
    assert isinstance(projector.build_projector(
        ProjectorConfig(input_dim=16, out_dim=8), device="meta"),
        projector.ResNetSwinProjector)
    gelu = projector.build_projector(ProjectorConfig(
        projector_type="mlp2x_gelu", input_dim=16, out_dim=8))[1]
    assert isinstance(gelu, torch.nn.GELU) and gelu.approximate == "none"
    with pytest.raises(ValueError, match="unknown projector_type"):
        projector.build_projector(ProjectorConfig(projector_type="mlp2x_relu"))


def _batch(cfg, K=3, seed=7):
    """A panoptic prompt spliced with (S/32)^2 image tokens."""
    S, Q = cfg.image_size, cfg.mask_decoder.num_queries
    ids = [11, 12, IMAGE_TOKEN_INDEX, 13] + [CLS_TOKEN_INDEX] * K + [
        14, SEG_TOKEN_INDEX, 15]
    s = splice(ids, [-100] * len(ids), num_image_tokens=(S // 32) ** 2,
               num_seg_queries=Q, pad_len=64,
               class_name_ids=np.arange(21, 21 + 2 * K),
               cls_indices=np.repeat(np.arange(K), 2))
    batch = {k: np.asarray(v)[None] for k, v in s.as_dict().items()}
    batch["images"] = np.random.default_rng(seed).standard_normal(
        (1, S, S, 3)).astype(np.float32)
    return batch


@pytest.mark.parametrize("ptype", ["linear", "mlp2x_gelu"])
def test_psalm_forward_with_projector_matches_jax(ptype):
    base = tiny_test_config()
    cfg = base.replace(projector=dataclasses.replace(base.projector,
                                                     projector_type=ptype))
    variables = convert_psalm_checkpoint(parity_state_dict(base), base)
    # the projector of this type, from its own init (LeCun scale)
    res5 = jnp.zeros((1, 2, 2, cfg.projector.input_dim))
    params = dict(variables["params"])
    params["mm_projector"] = jbuild_projector(cfg.projector).init(
        jax.random.PRNGKey(1), res5)["params"]
    variables = jax.tree.map(jnp.asarray, {"params": params})
    batch = _batch(cfg)
    want = jax.jit(functools.partial(
        JPSALM(cfg).apply, use_class_names=True, num_class_names=3,
        compute_logits=False))(variables,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    port = load_port(PSALM(cfg, device="cpu"),
                     from_jax.jax_to_torch_state_dict(variables, cfg))
    with torch.no_grad():
        tokens = port.encode_images(torch.from_numpy(batch["images"]))[1]
        got = port({k: torch.from_numpy(v) for k, v in batch.items()},
                   num_class_names=3)
    assert tokens.shape == (1, (cfg.image_size // 32) ** 2,
                            cfg.projector.out_dim)
    for key in ("pred_masks", "pred_class_name_logits"):
        assert_close_rel(got[key].numpy(), want[key], rel=1e-3)
