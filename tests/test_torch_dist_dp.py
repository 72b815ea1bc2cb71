"""Data parallelism against the one-process step, sharded resume at another
world size, and data-parallel eval, on gloo CPU ranks (the port only).

  * Two data ranks (model 1, then model 2 on 4 ranks) take two steps on
    their halves of a global panoptic batch of 4 and two on an mm_conv
    one, against one process stepping on the whole batches: the panoptic
    rows hold 3, 1, 2 and 0 valid masks, the mm_conv rows 13, 5, 9 and 1
    labelled tokens, so
    that a rank's own mask or token count differs from the global one (the
    mask losses, the [SEG] / region pos_weight, the class-name weights and
    the conversation loss all divide by global counts). The first step of
    each kind: losses and grad norm 1e-4 relative, gradients 1e-3 of their
    magnitude; the parameters after the four steps by
    tests/test_torch_train.py's rule.
  * A Trainer saves at world 2 after two steps; a Trainer without a mesh
    and one at world 4 resume from it, and world 4 also from the
    one-process Trainer's save of what it loaded: the same parameters,
    moments (bit for bit) and count, and their next step equals world 2's
    (losses 1e-5 relative, parameters by the rule above).
  * ``train.py::main`` under torchrun on 2 CPU ranks: data parallel, the
    sampler sharded by data rank, rank 0 alone logging, a sharded
    checkpoint; then ``main`` without torchrun resumes it in this process.
  * ``EvalRunner(mesh=)`` over 2 ranks equals one process on
    tests/test_eval_dp.py's non-square batch of 4; the sampler's data-rank
    shards are disjoint and a global sum is the same on every rank
    (tests/test_multihost.py's checks). In the window mode at radius 0.5,
    the ranks' own rows give other offset statistics, yet the guard's
    decision, ``window_stats`` and maps on every rank are one process's.

Each group of ranks runs several of these in turn (``in_turn``), so that
the processes' start-up is paid twice for the file, not once a check.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from test_torch_modules import load_port, parity_state_dict
from test_torch_train import DUST, LR, point_draws
from torch_dist_workers import WordTokenizer, resume_steps, train_args

from psalm_tpu_torch.config import tiny_test_config
from psalm_tpu_torch.data.constants import IGNORE_INDEX
from psalm_tpu_torch.data.datasets import SyntheticPanopticDataset, collate
from psalm_tpu_torch.eval.runner import EvalRunner
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.parallel.launch import spawn
from psalm_tpu_torch.train import train as ttrain
from psalm_tpu_torch.train.train_step import warmup_cosine_schedule

WORKERS = "torch_dist_workers"
K, STEPS, B = 4, 2, 4
RECORD = (0, STEPS)  # the first panoptic and the first mm_conv step
VALID = np.array([[1, 1, 1], [1, 0, 0], [1, 1, 0], [0, 0, 0]], bool)
LABELLED = (13, 5, 9, 1)


def _batches(cfg):
    """(panoptic, mm_conv) global batches of 4."""
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  K, num_samples=B, num_masks=3, seed=4)
    pan = collate([ds[i] for i in range(B)])
    pan["gt_valid"] = VALID.copy()
    conv = {k: v for k, v in pan.items() if not k.startswith("gt_")}
    conv["dataset_type"] = "mm_conv"
    tok, L = conv["tok_ids"], conv["tok_ids"].shape[1]
    text = (conv["attention_mask"] > 0) & (tok >= 0) & (
        tok < cfg.phi.vocab_size)
    labels = np.full_like(tok, IGNORE_INDEX)
    for b, n in enumerate(LABELLED):
        idx = np.flatnonzero(text[b])[-n:]
        labels[b, idx] = tok[b, idx]
    conv["labels"] = labels
    return pan, conv


def _one_process(cfg, sd, batches, draws, record):
    """``torch_dist_workers.train_steps``'s record of one process."""
    trainer = ttrain.Trainer(
        train_args(), cfg=cfg, model=load_port(PSALM(cfg, device="cpu",
                                                     remat=True), sd),
        device="cpu",
        uniform_fn=lambda g, shape: torch.from_numpy(draws[tuple(shape)]))
    out = {"metrics": [], "grads": {}}
    for i, batch in enumerate(batches):
        out["metrics"].append({k: float(v) for k, v in
                               trainer.step(batch).items()})
        if i in record:
            out["grads"][i] = {n: p.grad.clone() for n, p in trainer.trainable}
    out["params"] = {n: p.detach().clone() for n, p in trainer.trainable}
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    sd = parity_state_dict(cfg, seed=5)
    return cfg, sd, _batches(cfg), point_draws(cfg, B)


def _assert_steps_equal(got, want, record):
    """Each recorded step's losses, grad norm and gradients, and the last
    parameters."""
    keys = ("loss_mask", "loss_dice", "loss_class_name_class",
            "loss_llm", "loss", "grad_norm")
    live = {}
    for i in record:
        for k in keys:
            w, g = want["metrics"][i].get(k, 0.0), got["metrics"][i].get(k)
            if w:
                assert abs(g - w) <= 1e-4 * abs(w), (i, k, g, w)
        grads = want["grads"][i]
        floor = DUST * max(g.abs().max() for g in grads.values())
        bad = []
        for n, w in grads.items():
            err = (got["grads"][i][n] - w).abs().max()
            if err > 1e-3 * max(w.abs().max(), floor):
                bad.append((i, n, float(err), float(w.abs().max())))
            live[n] = live.get(n, False) | (w.abs() > floor)
        assert not bad, bad[:10]
    sched = warmup_cosine_schedule(LR, 10, 0.1)
    lrs = [sched(t) for t in range(len(got["metrics"]))]
    for n, w in want["params"].items():
        diff = (got["params"][n] - w).abs()
        assert diff.max() <= 2 * sum(lrs), n
        assert not live[n].any() or diff[live[n]].max() <= 0.1 * LR, n


@pytest.fixture(scope="module")
def one_process(setup):
    """One process's steps on the whole batches: panoptic, panoptic,
    mm_conv, mm_conv."""
    cfg, sd, (pan, conv), draws = setup
    return _one_process(cfg, sd, [pan] * STEPS + [conv] * STEPS, draws,
                        RECORD)


@pytest.mark.parametrize("model_par", [1, 2])
def test_data_parallel_steps_equal_one_process(setup, one_process, two_ranks,
                                               four_ranks, model_par):
    # the ranks' own counts differ from the global ones
    assert VALID[:2].sum() != VALID[2:].sum()
    assert sum(LABELLED[:2]) != sum(LABELLED[2:])
    assert one_process["metrics"][STEPS]["loss_llm"] > 0
    ranks = [r["steps"] for r in (two_ranks[0] if model_par == 1
                                  else four_ranks)]
    assert len(ranks) == 2 * model_par
    assert {r["mesh"][:2] for r in ranks} == {(2, model_par)}
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    _assert_steps_equal(ranks[0], one_process, RECORD)


def _criterion_inputs(cfg):
    """Random outputs of two layers with every head, and targets of a batch
    of 4 whose rows hold 3, 1, 2 and 0 valid masks."""
    g = torch.Generator().manual_seed(0)
    Q, S = cfg.mask_decoder.num_queries, cfg.image_size

    def layer():
        return {"pred_masks": torch.randn(B, Q, S // 4, S // 4, generator=g),
                "pred_class_name_logits": torch.randn(B, Q, K, generator=g),
                "pred_SEG_logits": torch.randn(B, Q, 1, generator=g),
                "pred_region_logits": torch.randn(B, 3, Q, generator=g)}

    outputs = {**layer(), "aux_outputs": [layer()]}
    masks = (torch.rand(B, 3, S, S, generator=g) > 0.6).float()
    targets = {"masks": masks, "labels": torch.randint(0, K - 1, (B, 3),
                                                       generator=g),
               "valid": torch.from_numpy(VALID)}
    return outputs, targets


def test_criterion_shares_sum_to_the_global_losses(setup, evaluated):
    """Every loss with its global count: the ranks' shares of the [SEG],
    class-name and region losses (pos_weight over the global entries and
    masks) and the mask losses sum to the one-process losses (1e-5)."""
    from psalm_tpu_torch.train.criterion import PSALMCriterion
    cfg, _, _, draws = setup
    ranks, _ = evaluated
    outputs, targets = _criterion_inputs(cfg)
    want = PSALMCriterion(cfg.loss, cfg.mask_decoder.num_queries,
                          uniform_fn=lambda _, shape: torch.from_numpy(
                              draws[tuple(shape)]))(
        torch.Generator(), outputs, targets, compute_seg=True,
        compute_class=True, compute_region=True)
    for k, w in want.items():
        got = sum(r["shares"][k] for r in ranks)
        assert w > 0 and abs(got - float(w)) <= 1e-5 * float(w), (k, got, w)


def _resume_batches(cfg):
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  K, num_samples=3 * B, num_masks=3,
                                  valid_masks=2, seed=9)
    return [collate([ds[i] for i in range(j * B, (j + 1) * B)])
            for j in range(3)]


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    """One group of two data ranks, in turn: the steps of
    ``test_data_parallel_steps_equal_one_process`` at model 1; two steps,
    a save at world 2 and a third step; the data-parallel eval, the
    sampler shards, the global sum and the criterion shares. Each rank's
    results by name, and the checkpoint's directory."""
    cfg, sd, (pan, conv), draws = setup
    out = str(tmp_path_factory.mktemp("ckpt"))
    ranks = spawn(f"{WORKERS}:in_turn", 2, (
        ("train_steps", (cfg, sd, [pan] * STEPS + [conv] * STEPS, draws, 1,
                         RECORD)),
        ("resume_steps", (cfg, sd, _resume_batches(cfg), draws, 1, out, 2)),
        ("eval_and_sampler", (cfg, sd, _eval_batch(cfg), K,
                              _criterion_inputs(cfg), draws)),
        ("window_guard", (_window_cfg(cfg), sd, _eval_batch(cfg), K))),
        device="cpu", threads=1)
    return [dict(zip(("steps", "saved", "eval", "guard"), r))
            for r in ranks], out


@pytest.fixture(scope="module")
def resumed_here(setup, two_ranks, tmp_path_factory):
    """A Trainer without a mesh resumes from world 2's checkpoint in this
    process, saves what it loaded (a one-process checkpoint) and steps."""
    cfg, sd, _, draws = setup
    again = str(tmp_path_factory.mktemp("ckpt1"))
    run = resume_steps(cfg, sd, _resume_batches(cfg), draws, 1, two_ranks[1],
                       0, distributed=False, resave_dir=again)
    return run, again


@pytest.fixture(scope="module")
def four_ranks(setup, two_ranks, resumed_here):
    """One group of four ranks, in turn: the steps at data 2 x model 2, and
    resumes at world 4 (4 x 1) from world 2's checkpoint and from the
    one-process one."""
    cfg, sd, (pan, conv), draws = setup
    batches = _resume_batches(cfg)
    ranks = spawn(f"{WORKERS}:in_turn", 4, (
        ("train_steps", (cfg, sd, [pan] * STEPS + [conv] * STEPS, draws, 2,
                         RECORD)),
        ("resume_steps", (cfg, sd, batches, draws, 1, two_ranks[1], 0)),
        ("resume_steps", (cfg, sd, batches, draws, 1, resumed_here[1], 0))),
        device="cpu", threads=1)
    return [dict(zip(("steps", "resumed", "resumed_from_one"), r))
            for r in ranks]


@pytest.fixture(scope="module")
def resumed(two_ranks, resumed_here, four_ranks):
    """World 2's save and third step; the runs that resumed from it at
    worlds 1 and 4."""
    ranks, _ = two_ranks
    return [r["saved"] for r in ranks], {
        1: [resumed_here[0]], 4: [r["resumed"] for r in four_ranks]}


def test_sharded_checkpoint_layout(resumed):
    saved, _ = resumed
    assert saved[0]["files"] == ["checkpoint.pt", "optimizer-0-0.pt",
                                 "optimizer-1-0.pt"]
    assert saved[0]["step"] == saved[0]["count"] == 2


def _assert_resumed(want, got):
    """``got`` resumed from ``want``'s save: the same step, count,
    parameters and moments, and the step after."""
    assert got["step"] == got["count"] == 2
    for n, p in want["params"].items():
        assert torch.equal(got["params"][n], p), n
    assert set(got["moments"]) == set(want["moments"])
    for n, m in want["moments"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["moments"][n][k], m[k]), (n, k)
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= 1e-5 * abs(w), k
    # the step after: tests/test_torch_train.py's rule, an entry whose
    # moment is float dust (DUST of the largest) within 2 lr, the rest
    # within 0.1 lr
    lr = warmup_cosine_schedule(LR, 10, 0.1)(2)
    mu = {n: m["exp_avg"].abs() for n, m in want["moments"].items()}
    floor = DUST * max(m.max() for m in mu.values())
    moved = 0
    for n, p in want["after"].items():
        diff = (got["after"][n] - p).abs()
        assert diff.max() <= 2 * lr, n
        live = mu[n] > floor
        assert not live.any() or diff[live].max() <= 0.1 * LR, n
        moved += not torch.equal(p, want["params"][n])
    assert moved > len(want["after"]) // 2


@pytest.mark.parametrize("world", [1, 4])
def test_resume_at_another_world_size(resumed, world):
    """World 2's checkpoint resumed by one process without a mesh (world 1)
    and at world 4."""
    saved, runs = resumed
    _assert_resumed(saved[0], runs[world][0])


def test_one_process_checkpoint_resumes_at_world_4(resumed_here,
                                                   four_ranks):
    """What the one-process Trainer loaded and saved (the layout of a 1 x 1
    mesh) resumes at world 4 as world 2's own checkpoint does."""
    run, _ = resumed_here
    assert run["files"] == ["checkpoint.pt", "optimizer-0-0.pt"]
    _assert_resumed(run, four_ranks[0]["resumed_from_one"])


def _eval_batch(cfg):
    """tests/test_eval_dp.py's batch: 4 images, each with its own
    non-square content and original size."""
    batch = {k: np.asarray(v) for k, v in
             ge._panoptic_batch(cfg, B=B, num_classes=K).items()}
    s = cfg.image_size
    batch["padding_mask"] = np.ones((B, s, s), bool)
    rh, oh = [], []
    for b in range(B):
        nh, nw = 40 + 4 * b, 64 - 8 * b
        batch["padding_mask"][b, :nh, :nw] = False
        rh.append((nh, nw))
        oh.append((30 + 10 * b, 50 + 5 * b))
    batch["resized_hw"] = np.asarray(rh)
    batch["original_hw"] = np.asarray(oh)
    return batch


@pytest.fixture(scope="module")
def evaluated(setup, two_ranks):
    """Two ranks' data-parallel eval, sampler shards, global sum and
    criterion shares; one process's eval."""
    cfg, sd, _, _ = setup
    model = load_port(PSALM(cfg, device="cpu"), sd)
    ref = EvalRunner(model, cfg, num_class_names=K,
                     bucket_hw=(96, 96)).infer(_eval_batch(cfg))
    return [r["eval"] for r in two_ranks[0]], ref


def test_data_parallel_eval_equals_one_process(evaluated):
    ranks, ref = evaluated
    for r in ranks:
        got = r["infer"]
        for b in range(B):
            np.testing.assert_array_equal(got["panoptic_seg"][b],
                                          ref["panoptic_seg"][b])
            np.testing.assert_array_equal(got["sem_seg"][b], ref["sem_seg"][b])
        for k in ref["segments"]:
            np.testing.assert_array_equal(got["segments"][k],
                                          ref["segments"][k])
    assert ref["segments"]["valid"].any()


def _window_cfg(cfg):
    """The window mode at radius 0.5: the offsets pass it."""
    return cfg.replace(pixel_decoder=dataclasses.replace(
        cfg.pixel_decoder, attention_mode="window", window_radius=0.5))


def test_data_parallel_window_guard_equals_one_process(setup, two_ranks):
    """The window guard under a mesh: the two ranks' own rows give other
    statistics, yet both take one process's decision on the whole batch
    (the largest offset, the mean clamp share), and infer its maps."""
    cfg, sd, _, _ = setup
    wcfg = _window_cfg(cfg)
    ref = EvalRunner(load_port(PSALM(wcfg, device="cpu"), sd), wcfg,
                     num_class_names=K, bucket_hw=(96, 96))
    want = ref.infer(_eval_batch(cfg))
    ranks = [r["guard"] for r in two_ranks[0]]
    assert ranks[0]["own"] != ranks[1]["own"]
    assert ref.window_stats["max_clamp_frac"] > 1e-3
    for r in ranks:
        assert r["pixel_decoder"] == ref.cfg.pixel_decoder
        # a batch of 2 rows rounds the offset head's products apart from one
        # of 4: 1e-5 of the statistics
        for k, v in ref.window_stats.items():
            assert abs(r["stats"][k] - v) <= 1e-5 * max(abs(v), 1.0), k
        for b in range(B):
            np.testing.assert_array_equal(r["infer"]["panoptic_seg"][b],
                                          want["panoptic_seg"][b])
            np.testing.assert_array_equal(r["infer"]["sem_seg"][b],
                                          want["sem_seg"][b])


def test_sampler_shards_and_global_sum(evaluated):
    ranks, _ = evaluated
    assert [r["shard"] for r in ranks] == [(0, 2), (1, 2)]
    a, b = (set(r["seen"]) for r in ranks)
    assert a and b and a.isdisjoint(b)
    want = float(sum(range(4 * 2)) * 8)
    assert [r["sum"] for r in ranks] == [want, want]


@pytest.fixture(scope="module")
def torchrun_main(tmp_path_factory):
    """``torchrun --nproc_per_node=2`` of the training command line on the
    CPU (tests/torch_dist_workers.py as the script, its tokenizer
    injected), two steps: (process, tree, model directory, output
    directory)."""
    from psalm_tpu.config import tiny_test_config as jtiny
    from test_torch_train_main import _argv, _model_dir, _tree
    tmp = str(tmp_path_factory.mktemp("main"))
    root, out = _tree(tmp), os.path.join(tmp, "out")
    model = _model_dir(tmp, jtiny())
    here = os.path.dirname(os.path.abspath(__file__))
    argv = _argv(root, model, out, 2, ["--device", "cpu",
                                        "--dataloader_num_workers", "0"])
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here)] + sys.path))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", os.path.join(here, "torch_dist_workers.py"),
         *argv], env=env, capture_output=True, text=True, timeout=300)
    return proc, root, model, out


def test_main_under_torchrun(torchrun_main):
    """Two steps a rank on its own shard of the synthetic tree, one log
    line a step (rank 0's), the checkpoint of a 2 x 1 mesh, each rank's
    group destroyed at the end."""
    proc, _, _, out = torchrun_main
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for r in range(2):
        assert f"rank {r} of 2: step 2, group destroyed True" in proc.stdout
    with open(os.path.join(out, "train_log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines] == [0, 1]
    ckpt = os.path.join(out, "checkpoint-2")
    assert sorted(os.listdir(ckpt)) == ["checkpoint.pt", "optimizer-0-0.pt",
                                        "optimizer-1-0.pt"]
    payload = torch.load(os.path.join(ckpt, "checkpoint.pt"))
    assert payload["world"] == {"data": 2, "model": 1}
    assert payload["step"] == 2


def test_main_resumes_a_torchrun_checkpoint_in_one_process(
        torchrun_main, tmp_path, monkeypatch):
    """``main`` without torchrun's variables (one process, no mesh) goes on
    from the 2 x 1 checkpoint: the step and Adam's count carry over, and it
    saves the one-process layout."""
    from test_torch_train_main import _argv
    proc, root, model, out = torchrun_main
    assert proc.returncode == 0
    here = str(tmp_path / "out")
    shutil.copytree(out, here)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    state = ttrain.main(_argv(root, model, here, 3, [
        "--device", "cpu", "--dataloader_num_workers", "0"]),
        tokenizer=WordTokenizer())
    assert state.step == 3 and state.optimizer.count == 3
    assert not torch.distributed.is_initialized()
    with open(os.path.join(here, "train_log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1, 2]
    ckpt = os.path.join(here, "checkpoint-3")
    assert sorted(os.listdir(ckpt)) == ["checkpoint.pt", "optimizer-0-0.pt"]
    payload = torch.load(os.path.join(ckpt, "checkpoint.pt"))
    assert payload["world"] == {"data": 1, "model": 1}
