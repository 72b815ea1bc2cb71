"""LoRA, QLoRA, int8 and int4 Phi on a ('data', 'model') mesh, on gloo CPU
ranks: against psalm_tpu's mesh step and against one process.

JAX's rules (``psalm_tpu/parallel/mesh.py:47-53``) match only the kernel of
a float ``nn.Dense``, so JAX keeps every LoRA or quantized decoder layer
whole on each model rank and splits only ``lm_head``; the port places them
so (``parallel/mesh.py::param_spec`` reads the config).

  * 2 x 2 steps against JAX: three steps of the tiny config with rank-4
    adapters (``tests/test_torch_dist.py::phi_variant``) on a float base
    ("lora") and on an int8 base ("lora_int8", QLoRA), on
    ``tests/test_torch_train.py``'s panoptic batch of 2, a row a data rank,
    under ``psalm_finetune_mask``. JAX's side runs in a subprocess a kind
    (one jit a process, as ``test_torch_train.py`` runs it):
    ``make_train_step`` with ``psalm_finetune_optimizer`` on
    ``make_mesh(data=2, model=2)``, its parameters placed by
    ``param_shardings`` and its moments by ``init_state`` (ZeRO over
    'data'). ``jax.grad`` takes no int8 leaf, so JAX's step differentiates
    the trainable half (``partition_params``, as its docstring has it) and
    takes the frozen half, placed by ``param_shardings`` too, beside the
    batch. Tolerances are ``tests/test_torch_dist.py``'s: the first step's
    losses and grad norm 1e-4 relative; the first step's Adam moment mu =
    0.1 g within 1e-3 of its magnitude, floored at DUST of the largest; the
    parameters after three steps by its 3-step rule. The biases of the
    pixel decoder's convolutions before a GroupNorm have a zero gradient
    in exact arithmetic; there both sides' mu must be dust (under the
    floor), as ``BEFORE_NORM`` says.
  * int8 and int4 (no LoRA) at 2 x 2: the first step equals one process's
    (``tests/test_torch_dist_dp.py``'s rule: losses and grad norm 1e-4
    relative, gradients 1e-3 of their magnitude); their ``lm_head`` trains
    split, their layers' biases whole.
  * Data ranks: two QLoRA steps on 2 x 1 ranks equal the one-process
    steps (the same rule, and the parameters after them).
  * Resume: a QLoRA Trainer saves at 2 x 2 after two steps; one process
    (1 x 1) and 2 x 1 ranks resume from it: the same parameters and
    moments bit for bit, the same count, and the step after equal
    (``test_torch_dist_dp.py::_assert_resumed``).
  * Eval: ``EvalRunner(mesh=)`` with an int8, an int4 ("packed" and
    "pallas" storage), a LoRA and a QLoRA Phi at 2 x 2 and at 2 x 1 gives
    one process's maps and segments exactly, the one process run on the
    same rows as each data rank (2 of the 4: the int8 Phi's products over
    a batch of 4 round apart from a batch of 2's, and one pixel of 3000
    then falls the other way at a tie), and ``PSALM.logits`` (``lm_head``
    split at 2 x 2) within 1e-5 of one process's. Every tensor is whole
    on every rank but ``lm_head.weight`` at 2 x 2, and the state dict
    gathered by ``unshard`` equals the one process's (so ``merge_lora`` of
    it does).

One group of 4 ranks and one of 2 run their checks in turn (``in_turn``)
while the JAX processes run.
"""

import dataclasses
import os
import pickle
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_dist import _find_mu, phi_variant
from test_torch_dist_dp import (_assert_resumed, _assert_steps_equal,
                                _eval_batch, _one_process, _resume_batches)
from test_torch_modules import load_port
from test_torch_train import (DUST, HOST_KEYS, K, LR, STEPS, _args, _batch,
                              _config, point_draws)
from torch_dist_workers import resume_steps

from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu.parallel import mesh as jmesh
from psalm_tpu.train import lora as jlora
from psalm_tpu.train import train_step as jstep
from psalm_tpu.train.criterion import PSALMCriterion as JCriterion
from psalm_tpu.train.train import Trainer as JTrainer
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.eval.runner import EvalRunner, _join
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.parallel.launch import spawn
from psalm_tpu_torch.parallel.mesh import local_rows
from psalm_tpu_torch.train import lora
from psalm_tpu_torch.train.train_step import warmup_cosine_schedule

WORKERS = "torch_dist_workers"
JAX_KINDS = ("lora", "lora_int8")
QUANT_KINDS = ("int8", "int4")
EVAL_KINDS = ("int8", "int4", "int4_pallas", "lora", "lora_int8")
DP_STEPS = 2
# a convolution's bias right before a GroupNorm: its gradient is zero in
# exact arithmetic, so both sides hold float dust there, and it must lie
# under the floor (DUST of the largest moment) on both. Without Phi's
# gradients the largest moment of a LoRA step is about 1.0, and the dust,
# about 1e-7, is as large as 1e-3 of that floor.
BEFORE_NORM = re.compile(
    r"^pixel_decoder\.(input_proj\.\d+|adapter_\d+|layer_\d+)\.0\.bias$")


def kind_config(kind):
    """(cfg, JAX variables, the port's state dict) of a Phi ``kind``
    (``phi_variant``'s, or "int4_pallas": int4 in K4's storage)."""
    storage = "pallas" if kind == "int4_pallas" else "packed"
    cfg, variables = phi_variant(*_config("deformable"),
                                 kind.replace("_pallas", ""))
    cfg = cfg.replace(phi=dataclasses.replace(cfg.phi,
                                              quant_storage=storage))
    return cfg, variables, jax_to_torch_state_dict(variables, cfg)


def _jax_lora_steps(kind):
    """JAX's side for ``kind``, in a fresh process: the three steps'
    metrics, the first step's mu and the parameters after three steps, as
    torch state dicts (the frozen half's mu as zeros)."""
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg, variables, _ = kind_config(kind)
    draws = point_draws(cfg, 2)
    trainer = JTrainer(_args(gradient_checkpointing=False), cfg=cfg,
                       model=JPSALM(cfg))
    trainer.criterion = JCriterion(
        cfg.loss, cfg.mask_decoder.num_queries,
        uniform_fn=lambda key, shape: draws[tuple(shape)])
    loss_fn = trainer._seg_loss_fn(dict(use_class_names=True,
                                        num_class_names=K))
    train, frozen = jlora.partition_params(
        variables["params"], jlora.psalm_finetune_mask(variables["params"]))
    train = {"params": train}
    frozen = {"params": frozen, "batch_stats": variables["batch_stats"]}
    tx = jlora.psalm_finetune_optimizer(trainer.tx, train)

    def step_loss(tr, batch, rng):
        fz = batch["frozen"]
        return loss_fn({"params": jlora.combine_params(tr["params"],
                                                       fz["params"]),
                        "batch_stats": fz["batch_stats"]}, batch["rows"], rng)

    mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t_sh = jmesh.param_shardings(mesh, train)
    rows = NamedSharding(mesh, P("data"))
    batch = {"rows": {k: jax.device_put(jnp.asarray(v), rows)
                      for k, v in _batch(cfg).items() if k not in HOST_KEYS},
             "frozen": jax.device_put(frozen,
                                      jmesh.param_shardings(mesh, frozen))}

    def whole(tr, fz):
        return jax_to_torch_state_dict(
            {"params": jlora.combine_params(tr["params"], fz),
             "batch_stats": frozen["batch_stats"]}, cfg)

    metrics, mu = [], None
    with mesh:
        state = jstep.init_state(jax.device_put(train, t_sh), tx, mesh,
                                 param_sh=t_sh)
        step = jstep.make_train_step(step_loss, tx)
        for i in range(STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                mu = whole(jax.tree.map(np.asarray,
                                        _find_mu(state.opt_state)),
                           jax.tree.map(np.zeros_like, frozen["params"]))
        params = whole(state.params, frozen["params"])
    return metrics, mu, params


def jax_lora_steps(kind, tmp_dir):
    out = os.path.join(str(tmp_dir), f"jax_lora_steps_{kind}.pkl")
    paths = [os.path.dirname(os.path.abspath(__file__)),
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    code = (f"import pickle, sys; sys.path[:0] = {paths!r}; "
            "import test_torch_dist_lora as t; "
            f"pickle.dump(t._jax_lora_steps({kind!r}), open({out!r}, 'wb'))")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), out


def trainable_names(cfg, variables):
    """The port names of ``psalm_finetune_mask``'s leaves in JAX's tree."""
    flags = jax.tree.map(lambda p, m: np.full(np.shape(p), float(m),
                                              np.float32),
                         variables["params"],
                         jlora.psalm_finetune_mask(variables["params"]))
    sd = jax_to_torch_state_dict({**variables, "params": flags}, cfg)
    return {k for k, v in sd.items() if not k.endswith(
        ("running_mean", "running_var")) and np.all(v == 1.0)}


def _hidden(cfg):
    rng = np.random.default_rng(6)
    return rng.standard_normal((2, 5, cfg.phi.hidden_size)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests read: each kind's config and state dict, JAX's
    steps, the 4-rank and 2-rank groups' results, and this process's
    one-process runs."""
    tmp = tmp_path_factory.mktemp("lora")
    procs = {k: jax_lora_steps(k, tmp) for k in JAX_KINDS}
    try:
        kinds = {k: kind_config(k)
                 for k in dict.fromkeys(JAX_KINDS + EVAL_KINDS)}
        cfg_q, _, sd_q = kinds["lora_int8"]
        batch = _batch(cfg_q)
        draws, draws4 = point_draws(cfg_q, 2), point_draws(cfg_q, 4)
        resume = _resume_batches(cfg_q)
        ebatch = _eval_batch(cfg_q)
        hidden = _hidden(cfg_q)
        out = str(tmp / "ckpt")
        calls = [("train_steps", (kinds[k][0], kinds[k][2], [batch] * STEPS,
                                  draws, 2)) for k in JAX_KINDS]
        calls += [("train_steps", (kinds[k][0], kinds[k][2], [batch], draws,
                                   2)) for k in QUANT_KINDS]
        calls.append(("resume_steps", (cfg_q, sd_q, resume, draws4, 2, out,
                                       2)))
        evals = [(kinds[k][0], kinds[k][2], ebatch, K) for k in EVAL_KINDS]
        four = spawn(f"{WORKERS}:in_turn", 4, calls + [
            ("mesh_eval", a + (2, hidden)) for a in evals],
            device="cpu", threads=1)
        two = spawn(f"{WORKERS}:in_turn", 2, [
            ("train_steps", (cfg_q, sd_q, [batch] * DP_STEPS, draws, 1)),
            ("resume_steps", (cfg_q, sd_q, resume, draws4, 1, out, 0))] + [
            ("mesh_eval", a + (1, hidden)) for a in evals],
            device="cpu", threads=1)
        here = {
            "dp": _one_process(cfg_q, sd_q, [batch] * DP_STEPS, draws, (0,)),
            "quant": {k: _one_process(kinds[k][0], kinds[k][2], [batch],
                                      draws, (0,)) for k in QUANT_KINDS},
            "resumed": resume_steps(cfg_q, sd_q, resume, draws4, 1, out, 0,
                                    distributed=False)}
        here["eval"] = {}
        for k in EVAL_KINDS:
            cfg, _, sd = kinds[k]
            model = load_port(PSALM(cfg, device="cpu"), sd).eval()
            with torch.no_grad():
                logits = model.logits(torch.from_numpy(hidden))
            runner = EvalRunner(model, cfg, num_class_names=K,
                                bucket_hw=(96, 96))
            here["eval"][k] = {"infer": _join([runner.infer(local_rows(
                ebatch, SimpleNamespace(data=2, data_rank=r)))
                for r in range(2)]), "logits": logits}
        jax_side = {}
        for k, (proc, path) in procs.items():
            # each JAX process takes about 90 s alone; this bounds a hang
            _, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-3000:]
            with open(path, "rb") as f:  # written just now by the process
                jax_side[k] = pickle.load(f)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    n_jax, n_quant = len(JAX_KINDS), len(QUANT_KINDS)
    return {
        "kinds": kinds, "jax": jax_side,
        "steps": {k: [r[i] for r in four] for i, k in enumerate(JAX_KINDS)},
        "quant": {k: [r[n_jax + i] for r in four]
                  for i, k in enumerate(QUANT_KINDS)},
        "saved": four[0][n_jax + n_quant],
        "eval": {2: {k: [r[n_jax + n_quant + 1 + i] for r in four]
                     for i, k in enumerate(EVAL_KINDS)},
                 1: {k: [r[2 + i] for r in two]
                     for i, k in enumerate(EVAL_KINDS)}},
        "dp": [r[0] for r in two], "resumed": {1: here["resumed"],
                                               2: two[0][1]},
        "here": here}


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_mesh_steps_losses_equal_jax(runs, kind):
    jm = runs["jax"][kind][0]
    ranks = runs["steps"][kind]
    assert sorted(r["mesh"] for r in ranks) == [
        (2, 2, d, m) for d in range(2) for m in range(2)]
    for r in ranks[1:]:  # the global losses, on every rank
        assert r["metrics"] == ranks[0]["metrics"]
    tm = ranks[0]["metrics"][0]
    for k in ("loss_mask", "loss_dice", "loss_class_name_class", "loss",
              "grad_norm"):
        want = jm[0][k]
        assert want > 0
        assert abs(tm[k] - want) <= 1e-4 * abs(want), (k, tm[k], want)


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_mesh_first_moments_equal_jax(runs, kind):
    """mu = 0.1 g of the trainables after the first step; the trainables
    are JAX's ``psalm_finetune_mask``: the adapters and every module but
    the tower and Phi (``lm_head`` and the bases frozen)."""
    cfg, variables, _ = runs["kinds"][kind]
    mu = runs["jax"][kind][1]
    ranks = runs["steps"][kind]
    got = ranks[0]["exp_avg"][0]
    names = trainable_names(cfg, variables)
    assert set(got) == names
    assert sum(n.endswith((".lora_A", ".lora_B")) for n in names) == \
        12 * cfg.phi.num_layers
    assert not any(n.startswith(("lm_head.", "model.layers.")) and
                   not n.endswith((".lora_A", ".lora_B")) for n in names)
    floor = DUST * max(np.abs(mu[n]).max() for n in names)
    bad = []
    for name, g in got.items():
        w = np.asarray(mu[name], np.float64)
        if BEFORE_NORM.match(name):
            assert max(np.abs(w).max(), g.abs().max()) <= floor, name
            continue
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        if err > 1e-3 * max(np.abs(w).max(), floor):
            bad.append((name, err, np.abs(w).max()))
    assert not bad, bad[:10]
    grads = ranks[0]["grads"][0]
    for name, g in got.items():
        torch.testing.assert_close(g, 0.1 * grads[name], rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_mesh_parameters_after_three_steps_equal_jax(runs, kind):
    _, _, sd0 = runs["kinds"][kind]
    _, mu, want = runs["jax"][kind]
    ranks = runs["steps"][kind]
    sched = warmup_cosine_schedule(LR, 10, 0.1)
    lrs = [sched(t) for t in range(STEPS)]
    params = ranks[0]["params"]
    floor = DUST * max(np.abs(mu[n]).max() for n in params)
    for n, p in params.items():
        diff = np.abs(p.numpy() - want[n])
        assert diff.max() <= 2 * sum(lrs), (n, diff.max())
        live = np.abs(mu[n]) > floor
        assert not live.any() or diff[live].max() <= 0.1 * LR, (n, diff.max())
        if live.any():
            assert np.abs(p.numpy() - sd0[n]).max() > 0.5 * LR, n
    assert any(n.endswith(".lora_A") for n in params)


@pytest.mark.parametrize("kind", JAX_KINDS + QUANT_KINDS)
def test_lora_and_quantized_layers_stay_whole(runs, kind):
    """Every rank's moment slices: the decoder layers' trainables whole
    over 'model' (none is split), ``lm_head`` split when it trains, and
    Adam's moments sliced over 'data' by ``_zero_spec``."""
    ranks = runs["steps"].get(kind) or runs["quant"][kind]
    for r in ranks:
        split = {n for n, (_, _, local) in r["slices"].items()
                 if local != tuple(runs["kinds"][kind][2][n].shape)}
        assert split == ({"lm_head.weight"} if kind in QUANT_KINDS
                         else set()), split
        assert any(a is not None for a, _, _ in r["slices"].values())


@pytest.mark.parametrize("kind", QUANT_KINDS)
def test_quantized_mesh_step_equals_one_process(runs, kind):
    """An int8 or int4 Phi trains at 2 x 2 (``lm_head`` split, the
    quantized layers' biases whole): its first step is one process's."""
    ranks = runs["quant"][kind]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    want = runs["here"]["quant"][kind]
    _assert_steps_equal(ranks[0], want, (0,))
    assert "lm_head.weight" in want["grads"][0]


def test_qlora_data_ranks_equal_one_process(runs):
    ranks = runs["dp"]
    assert sorted(r["mesh"] for r in ranks) == [(2, 1, 0, 0), (2, 1, 1, 0)]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    _assert_steps_equal(ranks[0], runs["here"]["dp"], (0,))


def test_qlora_sharded_checkpoint_layout(runs):
    saved = runs["saved"]
    assert saved["files"] == ["checkpoint.pt"] + [
        f"optimizer-{d}-{m}.pt" for d in range(2) for m in range(2)]
    assert saved["step"] == saved["count"] == 2
    # the adapters and the replicated modules; no base, no int8 buffer
    assert all(not n.startswith(("lm_head.", "model.vision_tower."))
               and (not n.startswith("model.layers.")
                    or n.endswith((".lora_A", ".lora_B")))
               for n in saved["params"])


@pytest.mark.parametrize("mesh", ["1x1", "2x1"])
def test_qlora_resume_at_another_mesh_size(runs, mesh):
    """The 2 x 2 QLoRA checkpoint resumed by one process (1 x 1, no mesh)
    and on 2 x 1 ranks."""
    _assert_resumed(runs["saved"], runs["resumed"][int(mesh[0])])


@pytest.mark.parametrize("model_par", [2, 1])
@pytest.mark.parametrize("kind", EVAL_KINDS)
def test_mesh_eval_equals_one_process(runs, kind, model_par):
    want = runs["here"]["eval"][kind]
    _, _, sd = runs["kinds"][kind]
    ranks = runs["eval"][model_par][kind]
    assert len(ranks) == 2 * model_par
    for r in ranks:
        got = r["infer"]
        for b in range(len(want["infer"]["panoptic_seg"])):
            np.testing.assert_array_equal(got["panoptic_seg"][b],
                                          want["infer"]["panoptic_seg"][b])
            np.testing.assert_array_equal(got["sem_seg"][b],
                                          want["infer"]["sem_seg"][b])
        for k in want["infer"]["segments"]:
            np.testing.assert_array_equal(got["segments"][k],
                                          want["infer"]["segments"][k])
        scale = float(want["logits"].abs().max())
        assert float((r["logits"] - want["logits"]).abs().max()) <= \
            1e-5 * scale
        # only lm_head is split; every Phi linear (int8 weight, int4 bytes,
        # LoRA base and adapters) is whole on every rank
        split = {n for n, s in r["shapes"].items() if s != sd[n].shape}
        assert split == ({"lm_head.weight"} if model_par == 2 else set())
    assert want["infer"]["segments"]["valid"].any()
    # the state dict gathered over the model group is the one process's,
    # so train/lora.py's merge and graft take it as they take that one
    gathered = ranks[0]["gathered"]
    assert set(gathered) == set(sd)
    for k, v in gathered.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), k)
    if kind.startswith("lora"):
        alpha = runs["kinds"][kind][0].phi.lora_alpha
        merged = lora.merge_lora(gathered, alpha)
        for k, v in lora.merge_lora({k: torch.as_tensor(np.asarray(v))
                                     for k, v in sd.items()}, alpha).items():
            assert torch.equal(merged[k], v), k
