"""The training slice against psalm_tpu's on the CPU, tiny config, f32.

One ``parity_state_dict`` feeds both packages. A panoptic batch of the
synthetic dataset goes through three training steps on each side: JAX's
``Trainer._seg_loss_fn`` under ``jax.value_and_grad`` with its optax chain
(``make_optimizer``), and the port's ``Trainer.step``. Both criteria draw
the same points (``uniform_fn`` returns one fixed numpy array per shape, on
both sides, in every step).

Tolerances:
  * the first step's loss components and grad norm: 1e-4 relative;
  * each parameter's gradient after the first step: within 1e-3 of that
    gradient's largest magnitude, floored at DUST of the model's largest
    gradient entry (the tiny slice stacks Swin, Phi, the pixel decoder and
    three decoder layers; f32 summation order differs);
  * the parameters after three steps (lr 0, then lr and 0.97 lr): every
    entry within 2 lr per step, as far as two Adam paths can part, which
    the entries whose gradient is float dust (random signs; DUST below)
    reach; every other entry within 0.1 lr.

The port runs with gradient checkpointing (``remat``) and JAX without, so
the tests also show that recomputation leaves the gradients as they were.
The dense mode's JAX side is its einsum branch, which is what it runs on
the CPU; the port's is K5's plain versions, forward and backward.
"""

import argparse
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

from test_torch_flash import dense_mode_variables
from test_torch_modules import load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu.train.criterion import PSALMCriterion as JCriterion
from psalm_tpu.train.train import Trainer as JTrainer
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.data.datasets import (SyntheticPanopticDataset,
                                           UnifiedTaskSampler, collate)
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.train import train as ttrain
from psalm_tpu_torch.train.train_step import warmup_cosine_schedule

torch.backends.cuda.matmul.allow_tf32 = False

K, STEPS, LR = 4, 3, 1e-4
# a gradient (entry) below DUST of the model's largest gradient entry is
# float dust: in exact arithmetic it is zero (a bias before a norm layer; the
# class-name projector's bias and the attention key biases, which shift every
# logit of a softmax alike), and both sides hold rounding noise there
DUST = 1e-4
HOST_KEYS = ("dataset_type", "num_class_names", "image_id", "file_name",
             "resized_hw", "original_hw")


def _args(output_dir="/nonexistent", **kw):
    base = dict(output_dir=output_dir, learning_rate=LR, warmup_ratio=0.1,
                weight_decay=0.0, num_train_steps=10,
                per_device_train_batch_size=2, save_steps=2,
                save_total_limit=1, logging_steps=1,
                gradient_checkpointing=True, bf16=False, seed=0,
                seg_task="panoptic", pixel_decoder_mode="deformable")
    base.update(kw)
    return argparse.Namespace(**base)


def point_draws(cfg, B, seed=11):
    """One fixed U[0, 1) array per draw shape of the tiny criterion: the
    matching points, the oversampled probe and the random remainder."""
    c = cfg.loss
    P = c.train_num_points
    n_unc = int(c.importance_sample_ratio * P)
    rng = np.random.default_rng(seed)
    return {s: rng.uniform(size=s).astype(np.float32)
            for s in ((B, P, 2), (B, int(P * c.oversample_ratio), 2),
                      (B, P - n_unc, 2))}


def _batch(cfg, seed=4):
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  K, num_samples=2, num_masks=3, seed=seed)
    return collate([ds[0], ds[1]])


def _jax_steps(mode):
    """JAX's side of ``run_both``, run in a fresh process (``jax_steps``):
    the first step's metrics, loss and grad norm, its gradients and the
    parameters after three steps, both as torch state dicts (numpy)."""
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg, variables = _config(mode)
    draws = point_draws(cfg, 2)
    trainer = JTrainer(_args(gradient_checkpointing=False), cfg=cfg,
                       model=JPSALM(cfg))
    trainer.criterion = JCriterion(
        cfg.loss, cfg.mask_decoder.num_queries,
        uniform_fn=lambda key, shape: draws[tuple(shape)])
    loss_fn = trainer._seg_loss_fn(dict(use_class_names=True,
                                        num_class_names=K))
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()
             if k not in HOST_KEYS}
    params, opt_state = variables, trainer.tx.init(variables)
    first = None
    for _ in range(STEPS):
        (loss, metrics), grads = value_and_grad(params, batch,
                                                jax.random.PRNGKey(0))
        if first is None:
            first = ({k: float(v) for k, v in metrics.items()}, float(loss),
                     float(optax.global_norm(grads)),
                     jax_to_torch_state_dict(grads, cfg))
        updates, opt_state = trainer.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return first, jax_to_torch_state_dict(params, cfg)


def jax_steps(mode, tmp_dir):
    """``_jax_steps`` in a fresh Python process, its result pickled to
    ``tmp_dir``: there it is the process's only jit of the step. (A second
    jit of it in one process, for the other mode or the same one again, ran
    with the first trace's hoisted numpy constants: "supplied 300 buffers,
    compiled program expected 321".)"""
    out = os.path.join(str(tmp_dir), f"jax_steps_{mode}.pkl")
    paths = [os.path.dirname(os.path.abspath(__file__)),
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    code = (f"import pickle, sys; sys.path[:0] = {paths!r}; "
            "import test_torch_train as t; "
            f"pickle.dump(t._jax_steps({mode!r}), open({out!r}, 'wb'))")
    # about three times the 70-82 s the process took in a full run of tests/
    # with 6 workers on 8 cores, so that a hang fails inside the run with
    # its stderr
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=250)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:  # written just now by the process above
        return pickle.load(f)


def _config(mode):
    cfg = tiny_test_config()
    variables = convert_psalm_checkpoint(parity_state_dict(cfg, seed=5), cfg)
    if mode == "dense":
        cfg = cfg.replace(pixel_decoder=dataclasses.replace(
            cfg.pixel_decoder, attention_mode="dense", transformer_nheads=1))
        variables = dense_mode_variables(variables, cfg)
    return cfg, jax.tree.map(jnp.asarray, variables)


def _run_port(cfg, sd, batch_np, draws):
    model = load_port(PSALM(cfg, device="cpu", remat=True), sd)
    trainer = ttrain.Trainer(
        _args(), cfg=cfg, model=model, device="cpu",
        uniform_fn=lambda gen, shape: torch.from_numpy(draws[tuple(shape)]))
    first = None
    for _ in range(STEPS):
        metrics = trainer.step(batch_np)
        if first is None:
            grads = {n: (p.grad.clone() if p.grad is not None
                         else torch.zeros_like(p))
                     for n, p in trainer.trainable}
            first = ({k: float(v) for k, v in metrics.items()}, grads)
    return first, model


def run_both(mode, tmp_dir):
    """Three steps of each package from one state dict, in ``mode``:
    (cfg, JAX's first step, JAX's parameters, the port's first step, (the
    port's model, the initial state dict))."""
    cfg, variables = _config(mode)
    sd0 = jax_to_torch_state_dict(variables, cfg)
    tfirst, model = _run_port(cfg, sd0, _batch(cfg), point_draws(cfg, 2))
    jfirst, jparams = jax_steps(mode, tmp_dir)
    return cfg, jfirst, jparams, tfirst, (model, sd0)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The deformable pixel decoder (tests/test_torch_train_dense.py runs the
    same tests in the dense mode)."""
    return run_both("deformable", tmp_path_factory.mktemp("jax"))


def test_first_step_losses_and_grad_norm(steps):
    cfg, (jm, jloss, jnorm, _), _, (tm, _), _ = steps
    for k in ("loss_mask", "loss_dice", "loss_class_name_class"):
        assert jm[k] > 0
        assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm[k], jm[k])
    for k in ("loss_SEG_class", "loss_region_class"):
        assert tm[k] == jm[k] == 0.0
    assert abs(tm["loss"] - jloss) <= 1e-4 * jloss
    assert abs(tm["grad_norm"] - jnorm) <= 1e-4 * jnorm, (tm["grad_norm"], jnorm)


def test_first_step_parameter_gradients(steps):
    cfg, (_, _, _, want), _, (_, tgrads), _ = steps
    # the frozen tower gets no gradient on either side
    tower = [k for k in want if k.startswith("model.vision_tower.")]
    assert tower and all(not np.any(want[k]) for k in tower)
    assert not any(n.startswith("model.vision_tower.") for n in tgrads)
    floor = DUST * max(np.abs(w).max() for w in want.values())
    bad = []
    for name, got in tgrads.items():
        w = np.asarray(want[name], np.float64)
        err = np.abs(got.numpy().astype(np.float64) - w).max()
        if err > 1e-3 * max(np.abs(w).max(), floor):
            bad.append((name, err, np.abs(w).max()))
    assert not bad, bad[:10]
    # a gradient reached every module the loss reads
    for prefix in ("model.layers.0.", "model.mm_projector.", "pixel_decoder.",
                   "predictor.", "class_name_projector.", "seg_query"):
        assert any(n.startswith(prefix) and tgrads[n].abs().max() > 0
                   for n in tgrads), prefix


def test_parameters_after_three_steps(steps):
    cfg, (_, _, _, grads), want, _, (model, sd0) = steps
    sched = warmup_cosine_schedule(LR, 10, 0.1)
    lrs = [sched(t) for t in range(STEPS)]
    assert lrs[0] == 0.0 and min(lrs[1:]) > 0.9 * LR
    floor = DUST * max(np.abs(g).max() for g in grads.values())
    for n, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[n])
        # two Adam paths part by at most 2 lr a step, which the entries
        # whose gradient is float dust (signs at random) may reach
        assert diff.max() <= 2 * sum(lrs), (n, diff.max())
        # the rest take the same path
        live = np.abs(grads[n]) > floor
        assert not live.any() or diff[live].max() <= 0.1 * LR, (n, diff.max())
        # two updates with lr > 0 moved every parameter with a gradient, and
        # not the frozen tower
        moved = np.abs(p.detach().numpy() - sd0[n]).max()
        if n.startswith("model.vision_tower."):
            assert moved == 0, n
        elif live.any():
            assert moved > 0.5 * LR, (n, moved)


def test_trainer_loop_saves_prunes_and_resumes(tmp_path):
    """Port only: three steps of Trainer.train keep checkpoint-3 alone (the
    keep-1 limit) and a log line per step; a fresh Trainer resumes at step 3
    and goes on to step 5 from the saved parameters and optimizer."""
    cfg = tiny_test_config()
    out = str(tmp_path / "out")
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  K, num_samples=3, num_masks=3,
                                  valid_masks=2)
    args = _args(out, num_train_steps=3)
    t1 = ttrain.Trainer(args, cfg, device="cpu")
    state = t1.train(UnifiedTaskSampler([ds], batch_size=2))
    assert state.step == 3 and t1.optimizer.count == 3
    assert sorted(os.listdir(out)) == ["checkpoint-3", "train_log.jsonl"]
    with open(os.path.join(out, "train_log.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 3

    args.num_train_steps = 5
    t2 = ttrain.Trainer(args, cfg, device="cpu")
    saved = dict(t1.trainable)
    assert t2.try_resume() == 3 and t2.optimizer.count == 3
    for n, p in t2.trainable:
        assert torch.equal(p, saved[n]), n
    state = t2.train(UnifiedTaskSampler([ds], batch_size=2))
    assert state.step == 5
    assert sorted(os.listdir(out)) == ["checkpoint-5", "train_log.jsonl"]


def test_train_config_and_remat_policy():
    """build_train_config and the remat_pixel policy as psalm_tpu's: dense
    mode takes 2 heads; window mode's manual VJP skips the pixel-decoder
    remat at batch 1 and follows --gradient_checkpointing above it."""
    from psalm_tpu.train.train import build_train_config as jbuild
    from psalm_tpu.train.train import parse_args as jparse
    for argv in (["--pixel_decoder_mode", "dense"],
                 ["--pixel_decoder_mode", "window"],
                 ["--pixel_decoder_mode", "window", "--window_custom_vjp", "0"],
                 ["--bf16", ""]):
        argv = ["--output_dir", "/tmp/x"] + argv
        got = ttrain.build_train_config(ttrain.parse_args(argv))
        want = jbuild(jparse(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), argv
    window = ["--output_dir", "/tmp/x", "--pixel_decoder_mode", "window"]
    for extra, policy in (([], False),
                          (["--per_device_train_batch_size", "2"], None),
                          (["--remat_pixel_decoder", "1"], True),
                          (["--remat_pixel_decoder", "0"], False)):
        args = ttrain.parse_args(window + ["--per_device_train_batch_size",
                                           "1"] + extra)
        assert ttrain.remat_pixel_policy(
            args, ttrain.build_train_config(args)) is policy, extra
    model = PSALM(tiny_test_config(), device="meta", remat=True,
                  remat_pixel=False)
    assert model.model.remat and not model.pixel_decoder.remat
    # training the tower builds since K3 has a backward
    # (tests/test_torch_train_backbone.py)
    assert PSALM(tiny_test_config(), device="meta",
                 train_backbone=True).train_backbone


@pytest.mark.parametrize("flag", ["--gradient_checkpointing", "--bf16",
                                  "--tune_mm_mlp_adapter"])
def test_boolean_flags_parse_both_spellings(flag, capsys):
    """"True"/"true"/"1" turn a flag on, "False"/"false"/"0" and "" turn it
    off (psalm_tpu's type=bool parses "False" and "0" as True), anything
    else is an argparse error."""
    argv = ["--output_dir", "/tmp/x", flag]
    for text, want in (("True", True), ("true", True), ("1", True),
                       ("False", False), ("false", False), ("0", False),
                       ("", False)):
        assert getattr(ttrain.parse_args(argv + [text]), flag[2:]) is want
    with pytest.raises(SystemExit):
        ttrain.parse_args(argv + ["yes"])
    assert "not a boolean: 'yes'" in capsys.readouterr().err
