"""Training the Swin tower (``PSALM(train_backbone=True)``) against
psalm_tpu on the CPU, tiny config, f32: K3's backward twin against
``jax.vjp`` of ``_xla_reference``, the drop path against JAX's, and one
tower-training step against JAX's.

Tolerances:
  * K3's backward twin: 1e-5 of each output's largest magnitude (the same
    f32 products, summed in another order);
  * the drop path: 1e-4 of the largest feature (the tower's f32 stack, as
    tests/test_torch_modules.py holds it);
  * the step: losses and grad norm to 1e-4 relative, each gradient, the
    tower's included, to 1e-3 of its largest magnitude floored at DUST of
    the largest (tests/test_torch_train.py's rule). The step runs at drop
    path rate 0 on both sides: at batch 1 a dropped block drops its whole
    branch, and JAX's step passes no dropout key.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from test_torch_modules import assert_close_rel, load_port, parity_state_dict
from test_torch_train import (DUST, HOST_KEYS, K, _args, _batch,
                              point_draws)

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu.models.swin import SwinTransformer as JSwin
from psalm_tpu.ops.swin_attention_pallas import _xla_reference
from psalm_tpu.train.criterion import PSALMCriterion as JCriterion
from psalm_tpu.train.train import Trainer as JTrainer
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.models.swin import (SwinTransformer, drop_path_rates,
                                         shift_attn_mask)
from psalm_tpu_torch.ops import swin_attention as sa
from psalm_tpu_torch.train import train as ttrain

torch.backends.cuda.matmul.allow_tf32 = False


# -- K3's backward twin ----------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_k3_backward_twin_matches_jax_vjp(masked):
    N, C, h, ws = 49, 64, 4, 7
    rng = np.random.default_rng(3)
    mask = shift_attn_mask(2 * ws, 2 * ws, ws, ws // 2)  # 4 windows
    Bn = 2 * mask.shape[0]
    qkv = rng.standard_normal((Bn, N, 3 * C)).astype(np.float32)
    bias = rng.standard_normal((h, N, N)).astype(np.float32)
    dout = rng.standard_normal((Bn, N, C)).astype(np.float32)
    scale = (C // h) ** -0.5
    m = mask if masked else None
    got = sa.window_attention_bwd(torch.from_numpy(qkv),
                                  torch.from_numpy(bias),
                                  torch.from_numpy(m) if masked else None,
                                  h, scale, torch.from_numpy(dout))
    full = (jnp.asarray(np.broadcast_to(mask[None], (2,) + mask.shape)
                        .reshape(Bn, N, N)) if masked else None)
    _, vjp = jax.vjp(lambda a, b: _xla_reference(a, b, full, h, scale),
                     jnp.asarray(qkv), jnp.asarray(bias))
    want = vjp(jnp.asarray(dout))
    for g, w in zip(got, want):
        assert_close_rel(g.numpy(), np.asarray(w), rel=1e-5)


# -- drop path -------------------------------------------------------------


def test_drop_path_rates_follow_jax_linspace():
    cfg = tiny_test_config().swin
    tower = SwinTransformer(cfg, device="meta")
    rates = [blk.drop_path for layer in tower.layers for blk in layer.blocks]
    np.testing.assert_array_equal(rates, np.linspace(0, cfg.drop_path_rate,
                                                     sum(cfg.depths)))
    np.testing.assert_array_equal(rates, drop_path_rates(cfg))
    assert rates[0] == 0.0 and rates[-1] == cfg.drop_path_rate == 0.3


def test_drop_path_keeps_and_scales_samples_as_jax(monkeypatch):
    """The tiny tower at rate 0.3 with pinned draws on both sides (JAX's
    ``jax.random.bernoulli`` replaced by u < p over the same numbers, in
    call order): the features agree, and some draws drop a branch."""
    cfg = tiny_test_config()
    variables = convert_psalm_checkpoint(parity_state_dict(cfg, seed=4), cfg)
    prefix = "model.vision_tower."
    tower = load_port(SwinTransformer(cfg.swin),
                      {k[len(prefix):]: v for k, v in
                       jax_to_torch_state_dict(variables, cfg).items()
                       if k.startswith(prefix)})
    images = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    draws = np.random.default_rng(1).uniform(
        size=(2 * sum(cfg.swin.depths), 2, 1, 1)).astype(np.float32)
    keep = 1 - np.repeat(drop_path_rates(cfg.swin), 2)[:, None, None, None]
    assert (draws >= keep).any() and (draws < keep).any()
    calls = []

    def bernoulli(key, p, shape):
        u = draws[len(calls)]
        calls.append(p)
        assert tuple(shape) == u.shape
        return jnp.asarray(u) < p

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    want = JSwin(cfg.swin).apply(
        {"params": variables["params"]["vision_tower"]}, jnp.asarray(images),
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    drawn = iter(draws)
    tower.uniform_fn = lambda gen, shape: torch.from_numpy(next(drawn))
    with torch.no_grad():
        got = tower(torch.from_numpy(images), torch.Generator())
    # the first block's rate is 0: JAX draws nothing there, and neither
    # does the port
    assert len(calls) == 2 * sum(cfg.swin.depths) - 2
    for g, w in zip(got, want):
        assert_close_rel(g.numpy(), np.asarray(w))
    with torch.no_grad():  # without a generator: deterministic
        plain = tower(torch.from_numpy(images))
    assert any(not torch.equal(a, b) for a, b in zip(plain, got))


# -- one tower-training step -------------------------------------------------


def _config():
    cfg = tiny_test_config()
    cfg = cfg.replace(swin=dataclasses.replace(cfg.swin, drop_path_rate=0.0))
    variables = convert_psalm_checkpoint(parity_state_dict(cfg, seed=5), cfg)
    return cfg, jax.tree.map(jnp.asarray, variables)


def _jax_step():
    """JAX's first tower-training step (Trainer._seg_loss_fn of a
    PSALM(train_backbone=True) under jax.value_and_grad): metrics, loss,
    grad norm and the gradients as a torch state dict."""
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg, variables = _config()
    draws = point_draws(cfg, 2)
    trainer = JTrainer(_args(gradient_checkpointing=False), cfg=cfg,
                       model=JPSALM(cfg, train_backbone=True))
    trainer.criterion = JCriterion(
        cfg.loss, cfg.mask_decoder.num_queries,
        uniform_fn=lambda key, shape: draws[tuple(shape)])
    loss_fn = trainer._seg_loss_fn(dict(use_class_names=True,
                                        num_class_names=K))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()
             if k not in HOST_KEYS}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables, batch, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()}, float(loss),
            float(optax.global_norm(grads)), jax_to_torch_state_dict(grads, cfg))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    cfg, variables = _config()
    sd = jax_to_torch_state_dict(variables, cfg)
    model = load_port(PSALM(cfg, device="cpu", remat=True,
                            train_backbone=True), sd)
    draws = point_draws(cfg, 2)
    trainer = ttrain.Trainer(
        _args(train_backbone=True), cfg=cfg, model=model, device="cpu",
        uniform_fn=lambda gen, shape: torch.from_numpy(draws[tuple(shape)]))
    metrics = {k: float(v) for k, v in trainer.step(_batch(cfg)).items()}
    grads = {n: p.grad.clone() for n, p in trainer.trainable}
    out = os.path.join(str(tmp_path_factory.mktemp("jax")), "step.pkl")
    paths = [os.path.dirname(os.path.abspath(__file__)),
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    code = (f"import pickle, sys; sys.path[:0] = {paths!r}; "
            "import test_torch_train_backbone as t; "
            f"pickle.dump(t._jax_step(), open({out!r}, 'wb'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:  # written just now by the process above
        return metrics, grads, pickle.load(f)


def test_tower_step_losses_and_grad_norm(steps):
    tm, _, (jm, jloss, jnorm, _) = steps
    for k in ("loss_mask", "loss_dice", "loss_class_name_class"):
        assert jm[k] > 0
        assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm[k], jm[k])
    assert abs(tm["loss"] - jloss) <= 1e-4 * jloss
    assert abs(tm["grad_norm"] - jnorm) <= 1e-4 * jnorm, (tm["grad_norm"],
                                                          jnorm)


def test_tower_step_gradients_include_the_tower(steps):
    _, tgrads, (_, _, _, want) = steps
    tower = [k for k in want if k.startswith("model.vision_tower.")]
    assert tower and set(tower) <= set(tgrads)
    # every parameter trains (the BatchNorm statistics are buffers)
    assert set(tgrads) == {k for k in want if ".running_" not in k}
    floor = DUST * max(np.abs(w).max() for w in want.values())
    bad = []
    for name, got in tgrads.items():
        w = np.asarray(want[name], np.float64)
        err = np.abs(got.numpy().astype(np.float64) - w).max()
        if err > 1e-3 * max(np.abs(w).max(), floor):
            bad.append((name, err, np.abs(w).max()))
    assert not bad, bad[:10]
    # the gradient reached every stage of the tower and its bias tables
    for prefix in ("patch_embed.", "layers.0.", "layers.3.", "norm3."):
        assert any(tgrads[n].abs().max() > 0 for n in tower
                   if n.startswith("model.vision_tower." + prefix)), prefix
    assert all(tgrads[n].abs().max() > 0 for n in tower
               if n.endswith("relative_position_bias_table"))
