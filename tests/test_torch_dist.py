"""Data and tensor parallelism against psalm_tpu's mesh step, on the CPU.

Four gloo processes of the port (data 2 x model 2: Phi and ``lm_head``
split over 'model', Adam's moments over 'data') take three training steps
on ``tests/test_torch_train.py``'s panoptic batch of 2, a row a data rank,
from one ``parity_state_dict``. JAX's side is ``make_train_step`` on
``make_mesh(data=2, model=2)`` of 4 of the 8 virtual CPU devices, its
parameters placed by ``param_shardings`` and its moments by ``init_state``
(ZeRO over 'data'), in a subprocess (one jit a process, as
``test_torch_train.py`` runs it). Both criteria draw the same points.

Tolerances are ``test_torch_train.py``'s: the first step's losses and grad
norm 1e-4 relative; the first step's Adam moment mu = 0.1 g (JAX's from its
optimizer state, the port's gathered from the ranks' slices) within 1e-3
of its magnitude, floored at DUST of the largest; the parameters after
three steps by its 3-step rule. Beside it: each rank's moment slices follow
``_zero_spec`` composed with the tensor-parallel spec, the port's
``_zero_spec`` and ``_TP_RULES`` equal JAX's on a table of shapes and on the
tiny model's every Phi name (with float, LoRA, int8, int4 and LoRA-on-int8
linears: ``phi_variant``), and the multi-card dry run on the same 4 CPU
ranks (no test makes a process group in the pytest process itself).
"""

import dataclasses
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_train import (DUST, HOST_KEYS, K, LR, STEPS, _args, _batch,
                              _config, point_draws)

from psalm_tpu.models import quant as jquant
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu.parallel import mesh as jmesh
from psalm_tpu.train import train_step as jstep
from psalm_tpu.train.criterion import PSALMCriterion as JCriterion
from psalm_tpu.train.train import Trainer as JTrainer
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.parallel import mesh as tmesh
from psalm_tpu_torch.parallel.dryrun import dryrun_multichip
from psalm_tpu_torch.parallel.launch import spawn
from psalm_tpu_torch.train import train_step as tstep
from psalm_tpu_torch.train.train_step import warmup_cosine_schedule

WORKERS = "torch_dist_workers"


def _find_mu(state):
    """The Adam first moment in an optax chain's state."""
    if hasattr(state, "mu"):
        return state.mu
    if isinstance(state, (tuple, list)):
        for s in state:
            mu = _find_mu(s)
            if mu is not None:
                return mu
    return None


def _jax_mesh_steps():
    """JAX's side, in a fresh process: the three steps' metrics, the first
    step's mu and the parameters after three steps, as torch state dicts."""
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg, variables = _config("deformable")
    draws = point_draws(cfg, 2)
    trainer = JTrainer(_args(gradient_checkpointing=False), cfg=cfg,
                       model=JPSALM(cfg))
    trainer.criterion = JCriterion(
        cfg.loss, cfg.mask_decoder.num_queries,
        uniform_fn=lambda key, shape: draws[tuple(shape)])
    loss_fn = trainer._seg_loss_fn(dict(use_class_names=True,
                                        num_class_names=K))
    mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    p_sh = jmesh.param_shardings(mesh, variables)
    rows = NamedSharding(mesh, P("data"))
    batch = {k: jax.device_put(jnp.asarray(v), rows)
             for k, v in _batch(cfg).items() if k not in HOST_KEYS}
    metrics, mu = [], None
    with mesh:
        state = jstep.init_state(jax.device_put(variables, p_sh), trainer.tx,
                                 mesh, param_sh=p_sh)
        step = jstep.make_train_step(loss_fn, trainer.tx)
        for i in range(STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                mu = jax_to_torch_state_dict(_find_mu(state.opt_state), cfg)
        params = jax_to_torch_state_dict(state.params, cfg)
    return metrics, mu, params


def jax_mesh_steps(tmp_dir):
    out = os.path.join(str(tmp_dir), "jax_mesh_steps.pkl")
    paths = [os.path.dirname(os.path.abspath(__file__)),
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    code = (f"import pickle, sys; sys.path[:0] = {paths!r}; "
            "import test_torch_dist as t; "
            f"pickle.dump(t._jax_mesh_steps(), open({out!r}, 'wb'))")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Both sides: (cfg, JAX's (metrics, mu, params), each port rank's
    (``train_steps``, ``dryrun_rank``), the initial state dict). JAX's
    process runs while the port's ranks do."""
    proc, out = jax_mesh_steps(tmp_path_factory.mktemp("jax"))
    try:
        cfg, variables = _config("deformable")
        sd0 = jax_to_torch_state_dict(variables, cfg)
        batch = _batch(cfg)
        # the same group then takes the dry run's step (one start-up)
        ranks = spawn(f"{WORKERS}:in_turn", 4, (
            ("train_steps", (cfg, sd0, [batch] * STEPS, point_draws(cfg, 2),
                             2)),
            ("dryrun_rank", ("cpu",))), device="cpu", threads=1)
        # the JAX process takes about 85 s alone; this bounds a hang
        _, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:  # written just now by the process above
        jax_side = pickle.load(f)
    return cfg, jax_side, [r for r, _ in ranks], sd0, [d for _, d in ranks]


def test_mesh_ranks_and_losses_agree(steps):
    cfg, (jm, _, _), ranks, _, _ = steps
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
    for k in ("loss_SEG_class", "loss_region_class"):
        assert tm[k] == jm[0][k] == 0.0


def test_first_step_moments_equal_jax(steps):
    """mu = 0.1 g after the first step, on both sides."""
    cfg, (_, mu, _), ranks, _, _ = steps
    got = ranks[0]["exp_avg"][0]
    assert set(got) == {n for n in mu
                        if not n.startswith("model.vision_tower.")
                        and not n.endswith(("running_mean", "running_var"))}
    floor = DUST * max(np.abs(w).max() for w in mu.values())
    bad = []
    for name, g in got.items():
        w = np.asarray(mu[name], np.float64)
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        if err > 1e-3 * max(np.abs(w).max(), floor):
            bad.append((name, err, np.abs(w).max()))
    assert not bad, bad[:10]
    # the port's moment is its gradient's: 0.1 g
    grads = ranks[0]["grads"][0]
    for name, g in got.items():
        torch.testing.assert_close(g, 0.1 * grads[name], rtol=1e-5,
                                   atol=1e-12)


def test_parameters_after_three_steps_equal_jax(steps):
    cfg, (_, mu, want), ranks, sd0, _ = steps
    sched = warmup_cosine_schedule(LR, 10, 0.1)
    lrs = [sched(t) for t in range(STEPS)]
    floor = DUST * max(np.abs(m).max() for m in mu.values())
    for n, p in ranks[0]["params"].items():
        diff = np.abs(p.numpy() - want[n])
        assert diff.max() <= 2 * sum(lrs), (n, diff.max())
        live = np.abs(mu[n]) > floor
        assert not live.any() or diff[live].max() <= 0.1 * LR, (n, diff.max())
        if live.any():
            assert np.abs(p.numpy() - sd0[n]).max() > 0.5 * LR, n


def test_moment_slices_follow_zero_spec_with_tp(steps):
    """Each rank's slice of each moment: the parameter's whole shape cut by
    the tensor-parallel spec over 'model' and by ``_zero_spec`` over
    'data'; Phi's q_proj split both ways on distinct axes
    (test_sharded_train.py::test_tp_shardings_survive_init_state)."""
    cfg, _, ranks, sd0, _ = steps
    for r in ranks:
        data, model, d, m = r["mesh"]
        for name, (axis, shard, local) in r["slices"].items():
            spec = tmesh.param_spec(name, cfg)
            full = sd0[name].shape
            zspec = tstep._zero_spec(full, spec, data)
            want_local = tuple(s // model if a == "model" else s
                               for s, a in zip(full, spec + (None,) * 4))
            want_shard = tuple(s // data if a == "data" else s
                               for s, a in zip(want_local, zspec + (None,) * 4))
            assert local == want_local, name
            assert shard == want_shard, (name, shard, want_shard)
            assert axis == (zspec.index("data") if "data" in zspec else None)
        q = "model.layers.0.self_attn.q_proj.weight"
        axis, shard, local = r["slices"][q]
        assert local[0] * 2 == sd0[q].shape[0] and axis == 1
        assert shard[1] * 2 == sd0[q].shape[1]


@pytest.mark.parametrize("shape,base,n", [
    ((64, 64), (None, "model"), 2), ((64, 64), ("model", None), 4),
    ((64,), ("model",), 2), ((512, 64), (), 3), ((3, 5), (), 2),
    ((), (), 2), ((7, 4, 8), (None, None, "model"), 4),
    ((2, 8), (("data", "model"),), 2), ((1, 16), (), 2)])
def test_zero_spec_equals_jax(shape, base, n):
    assert tstep._zero_spec(shape, base, n) == tuple(
        jstep._zero_spec(shape, P(*base), n))


def _tp_names(cfg, variables):
    """(torch name, JAX path) of every parameter leaf of the tiny model that
    ``jax_to_torch_state_dict`` carries across unpacked: each leaf is filled
    with its own index, and a torch tensor made of one index is that
    leaf's."""
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    paths = ["/".join(str(getattr(k, "key", k)) for k in kp) for kp, _ in flat]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(variables["params"]),
        [np.full(np.shape(v), i, np.float32) for i, (_, v) in enumerate(flat)])
    sd = jax_to_torch_state_dict({"params": marked,
                                  "batch_stats": variables["batch_stats"]},
                                 cfg)
    out = []
    for name, v in sd.items():
        vals = np.unique(v)
        if len(vals) == 1 and not name.endswith(("running_mean",
                                                  "running_var")):
            out.append((name, paths[int(vals[0])]))
    return out


LORA_RANK = 4
PHI_LINEARS = ("q_proj", "k_proj", "v_proj", "dense", "fc1", "fc2")
VARIANTS = ("float", "lora", "int8", "int4", "lora_int8")


def phi_variant(cfg, variables, kind, seed=3):
    """(cfg, variables) of JAX's PSALM with Phi's linears of ``kind``:
    "float" as given; "lora" each a ``LoRADense`` over the float layer
    (``base``), rank LORA_RANK, A and B drawn from N(0, 0.02^2) (B away
    from zero, so that A takes a gradient); "int8" / "int4" quantized by
    JAX's ``quantize_phi_int8`` / ``quantize_phi_int4`` (packed); and
    "lora_int8" the LoRA tree with its bases quantized to int8 (QLoRA)."""
    lora = kind.startswith("lora")
    bits = {"int8": 8, "int4": 4, "lora_int8": 8}.get(kind, 0)
    cfg = cfg.replace(phi=dataclasses.replace(
        cfg.phi, lora_rank=LORA_RANK if lora else 0, quant_bits=bits))
    rng = np.random.default_rng(seed)

    def adapt(node):
        k = np.asarray(node["kernel"])
        return {"base": node,
                "lora_A": jnp.asarray(rng.normal(
                    0.0, 0.02, (k.shape[0], LORA_RANK)).astype(np.float32)),
                "lora_B": jnp.asarray(rng.normal(
                    0.0, 0.02, (LORA_RANK, k.shape[1])).astype(np.float32))}

    def walk(node):
        if not isinstance(node, dict):
            return node
        return {k: adapt(v) if k in PHI_LINEARS and "kernel" in v
                else walk(v) for k, v in node.items()}

    params = dict(variables["params"])
    if lora:
        params["phi"] = {**params["phi"],
                         "model": walk(params["phi"]["model"])}
    variables = {**variables, "params": params}
    if bits == 8:
        variables = jquant.quantize_phi_int8(variables)
    elif bits == 4:
        variables = jquant.quantize_phi_int4(variables)
    return cfg, variables


# JAX's '.../bias$' rule splits a quantized (non-LoRA) layer's q/k/v/fc1
# bias; its kernel is whole, so that split is placement only (GSPMD gathers
# the bias back before the add) and the port keeps the bias whole
_QUANT_BIAS = r"phi/.*/(q_proj|k_proj|v_proj|fc1)/bias$"


@pytest.mark.parametrize("kind", VARIANTS)
def test_tp_rules_equal_jax(kind):
    """JAX's spec of each leaf, a kernel's reversed (flax [in, out], torch
    [out, in]), is the port's spec of its torch name, for each kind of Phi
    linear; the one difference is the quantized bias above. A float Phi
    splits its decoder layers and ``lm_head``; every other kind only
    ``lm_head``, and never the int8 ``weight``."""
    cfg, variables = phi_variant(*_config("deformable"), kind)
    pairs = _tp_names(cfg, variables)
    split = [n for n, _ in pairs if "model" in tmesh.param_spec(n, cfg)]
    if kind == "float":
        assert len(split) == 10 * cfg.phi.num_layers + 1, split
    else:
        assert split == ["lm_head.weight"], split
    names = {n for n, _ in pairs}
    if kind in ("int8", "lora_int8"):
        base = "model.layers.0.self_attn.q_proj." + (
            "base." if kind == "lora_int8" else "")
        assert {base + "weight", base + "scale"} <= names
    quant_bias = 0
    for name, path in pairs:
        want = tuple(jmesh.param_spec(path))
        if path.endswith("/kernel"):
            want = tuple(reversed(want + (None,) * (2 - len(want))))
        got = tmesh.param_spec(name, cfg)
        if kind in ("int8", "int4") and re.search(_QUANT_BIAS, path):
            assert want == ("model",) and got == (), (name, path, got, want)
            quant_bias += 1
            continue
        assert got == want or (not any(got) and not any(want)), (name, path,
                                                                 got, want)
    assert quant_bias == (4 * cfg.phi.num_layers
                          if kind in ("int8", "int4") else 0)


def test_dryrun_multichip_on_four_cpu_ranks(steps):
    """``dryrun_multichip(4, "cpu")``'s ranks (``dryrun_rank`` on 4 gloo
    processes), run by the group of the steps above."""
    ranks = steps[-1]
    assert [(r["data"], r["model"]) for r in ranks] == [(2, 2)] * 4
    assert all(r["tp_live"] and r["moments_split"] > 0 for r in ranks)
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for a, b in zip(r["panoptic_seg"], ranks[0]["panoptic_seg"]):
            np.testing.assert_array_equal(a, b)
    assert [m.shape for m in ranks[0]["panoptic_seg"]] == [(54, 62), (50, 58)]


def test_dryrun_on_cards_needs_the_cards():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"needs {n} cards"):
        dryrun_multichip(n, device="cuda")
