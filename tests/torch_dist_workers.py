"""The ranks' side of tests/test_torch_dist*.py: functions that
``psalm_tpu_torch.parallel.launch.spawn`` runs in each process of a gloo
group on the CPU. They import no JAX; their arguments and results are
numpy arrays, tensors on the CPU and configs.

Every result that is the same on every rank (whole parameters, gathered
moments) is returned by rank 0 alone; the others return what is their own.

Run as a script (by torchrun), it is the training command line
``psalm_tpu_torch.train.train.main`` with ``WordTokenizer``.
"""

import argparse
import os
import sys
import zlib

import torch
import torch.distributed as dist

from psalm_tpu_torch.data.datasets import UnifiedTaskSampler
from psalm_tpu_torch.eval.runner import EvalRunner
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.parallel.dryrun import dryrun_rank  # noqa: F401 (in_turn)
from psalm_tpu_torch.parallel.mesh import (all_reduce, host_shard_info,
                                           local_rows, make_mesh,
                                           shard_state_dict, unshard)
from psalm_tpu_torch.train.train import Trainer

torch.backends.cuda.matmul.allow_tf32 = False


def train_args(**kw):
    """tests/test_torch_train.py's arguments."""
    base = dict(output_dir="/nonexistent", learning_rate=1e-4,
                warmup_ratio=0.1, weight_decay=0.0, num_train_steps=10,
                per_device_train_batch_size=2, save_steps=2,
                save_total_limit=1, logging_steps=1,
                gradient_checkpointing=True, bf16=False, seed=0,
                seg_task="panoptic", pixel_decoder_mode="deformable")
    base.update(kw)
    return argparse.Namespace(**base)


def make_trainer(cfg, sd, model_par, draws, distributed=True, **args_kw):
    """A Trainer on a (world / model_par, model_par) mesh holding this
    rank's slices of ``sd`` (``distributed=False``: one process, no mesh),
    its criterion drawing ``draws[shape]``."""
    mesh = make_mesh(model=model_par, device="cpu") if distributed else None
    model = PSALM(cfg, device="cpu", remat=True, mesh=mesh)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}
                          if mesh is None else shard_state_dict(sd, mesh, cfg))
    return Trainer(train_args(**args_kw), cfg=cfg, model=model, device="cpu",
                   mesh=mesh,
                   uniform_fn=lambda g, shape: torch.from_numpy(
                       draws[tuple(shape)]))


def _whole(t, name, trainer):
    m = trainer.mesh
    return t if m is None else unshard(t, name, m, trainer.cfg)


def full_params(trainer):
    return {n: _whole(p.detach(), n, trainer).clone()
            for n, p in trainer.trainable}


def full_grads(trainer):
    return {n: _whole(p.grad, n, trainer).clone()
            for n, p in trainer.trainable}


def floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def train_steps(cfg, sd, batches, draws, model_par, record=(0,)):
    """One step per global batch of ``batches`` on this rank's rows: every
    step's global metrics; rank 0 also the gradients and first moments
    after the steps in ``record`` and the last parameters, whole; every
    rank its moment slices (name -> (slice axis, slice shape, local
    parameter shape))."""
    trainer = make_trainer(cfg, sd, model_par, draws)
    mesh, opt = trainer.mesh, trainer.optimizer
    out = {"metrics": [], "grads": {}, "exp_avg": {}}
    for i, batch in enumerate(batches):
        out["metrics"].append(floats(trainer.step(local_rows(batch, mesh))))
        if i in record:
            grads, moments = full_grads(trainer), opt.full_moments()
            if mesh.rank == 0:
                out["grads"][i] = grads
                out["exp_avg"][i] = {n: v["exp_avg"]
                                     for n, v in moments.items()}
    params = full_params(trainer)
    if mesh.rank == 0:
        out["params"] = params
    out["slices"] = {n: (a, tuple(s.shape), tuple(p.shape))
                     for n, a, s, p in zip(opt.names, opt.axes, opt.shards,
                                           opt.params)}
    out["mesh"] = (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank)
    return out


def resume_steps(cfg, sd, batches, draws, model_par, out_dir, save_at,
                 distributed=True, resave_dir=None):
    """``save_at`` > 0: steps on batches[:save_at], a save, then the step on
    batches[save_at]; 0: a resume from ``out_dir`` (and a save of what it
    loaded into ``resave_dir``, if given), then that step. Rank 0 returns
    the whole parameters and moments and the count after the save or the
    resume, and the step's metrics and parameters."""
    trainer = make_trainer(cfg, sd, model_par, draws, distributed,
                           output_dir=out_dir)
    mesh, opt = trainer.mesh, trainer.optimizer
    rows = (lambda b: b) if mesh is None else (lambda b: local_rows(b, mesh))
    if save_at:
        for batch in batches[:save_at]:
            trainer.step(rows(batch))
        trainer.save(save_at)
    else:
        save_at = trainer.try_resume()
        if resave_dir:
            trainer.args.output_dir = resave_dir
            trainer.save(save_at)
    out = {"step": trainer.state.step, "count": opt.count,
           "files": sorted(os.listdir(os.path.join(
               trainer.args.output_dir, f"checkpoint-{save_at}")))}
    params, moments = full_params(trainer), opt.full_moments()
    metrics = floats(trainer.step(rows(batches[save_at])))
    after = full_params(trainer)
    if trainer.rank_zero:
        out.update(params=params, moments=moments, metrics=metrics,
                   after=after)
    return out


def criterion_shares(cfg, mesh, outputs, targets, draws):
    """This data rank's share of every loss of ``PSALMCriterion`` (the [SEG],
    class-name and region heads on) on its rows of global outputs."""
    from psalm_tpu_torch.train.criterion import PSALMCriterion
    crit = PSALMCriterion(cfg.loss, cfg.mask_decoder.num_queries, mesh=mesh,
                          uniform_fn=lambda g, shape: torch.from_numpy(
                              draws[tuple(shape)]))

    def rows(d):  # local_rows counts the batch by "images"
        d = local_rows({**d, "images": outputs["pred_masks"]}, mesh)
        return {k: v for k, v in d.items() if k != "images"}

    out = {**rows(outputs), "aux_outputs": [rows(a) for a in
                                            outputs["aux_outputs"]]}
    tgt = rows(targets)
    losses = crit(torch.Generator(), out, tgt, compute_seg=True,
                  compute_class=True, compute_region=True)
    return {k: float(v) for k, v in losses.items()}


class _Indices:
    """32 samples whose content is their index (tests/test_multihost.py)."""
    dataset_type = "panoptic_coco"

    def __len__(self):
        return 32

    def __getitem__(self, i):
        return {"idx": i, "dataset_type": self.dataset_type}


def eval_and_sampler(cfg, sd, batch, K, crit_inputs, draws):
    """A data-parallel ``EvalRunner.infer`` of ``batch`` over every rank,
    the indices this data rank's sampler shard draws in 4 batches of 2, a
    global sum over the data group (tests/test_multihost.py's checks), and
    ``criterion_shares`` of ``crit_inputs`` (outputs, targets)."""
    mesh = make_mesh(device="cpu")
    model = PSALM(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    runner = EvalRunner(model.eval(), cfg, num_class_names=K,
                        bucket_hw=(96, 96), mesh=mesh)
    shard, nshards = host_shard_info(mesh)
    sampler = UnifiedTaskSampler([_Indices()], batch_size=2,
                                 shard_index=shard, num_shards=nshards, seed=7)
    seen = [s["idx"] for _ in range(4) for s in sampler.next_batch()]
    local = torch.arange(4.0)[:, None] + 4.0 * mesh.data_rank + torch.zeros(4, 8)
    return {"infer": runner.infer(batch), "seen": seen,
            "shard": (shard, nshards),
            "sum": float(all_reduce(local.sum(), mesh.data_group)),
            "world": dist.get_world_size(),
            "shares": criterion_shares(cfg, mesh, *crit_inputs, draws)}


def window_guard(cfg, sd, batch, K):
    """The data-parallel ``EvalRunner`` of ``cfg`` (the window mode) with
    its guard on ``batch``: each rank measures its own rows, and every rank
    must take the whole batch's decision. Returns the runner's
    ``window_stats``, its pixel decoder's config, its results, and this
    rank's own rows' statistics."""
    from psalm_tpu_torch.eval import instrument
    mesh = make_mesh(device="cpu")
    model = PSALM(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    runner = EvalRunner(model.eval(), cfg, num_class_names=K,
                        bucket_hw=(96, 96), mesh=mesh)
    own = instrument.summarize(instrument.offset_clamp_report(
        model, runner.stage(local_rows(batch, mesh))))
    out = runner.infer(batch)
    return {"stats": runner.window_stats, "own": own, "infer": out,
            "pixel_decoder": runner.cfg.pixel_decoder}


def mesh_eval(cfg, sd, batch, K, model_par, hidden):
    """``EvalRunner(mesh=)`` of ``cfg`` on a (world / model_par, model_par)
    mesh, ``PSALM(cfg, mesh=)`` holding ``shard_state_dict``'s slices of
    ``sd``: its results on ``batch``, the ``lm_head`` logits of ``hidden``
    (``PSALM.logits``, gathered over the model group), the local shape of
    every parameter and buffer, and (rank 0) the state dict gathered over
    the model group by ``unshard``."""
    mesh = make_mesh(model=model_par, device="cpu")
    model = PSALM(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(shard_state_dict(sd, mesh, cfg))
    runner = EvalRunner(model.eval(), cfg, num_class_names=K,
                        bucket_hw=(96, 96), mesh=mesh)
    with torch.no_grad():
        logits = model.logits(torch.as_tensor(hidden))
    local = model.state_dict()
    gathered = {k: unshard(v, k, mesh, cfg) for k, v in local.items()}
    return {"infer": runner.infer(batch), "logits": logits,
            "shapes": {k: tuple(v.shape) for k, v in local.items()},
            "gathered": gathered if mesh.rank == 0 else None}


def in_turn(*calls):
    """(name of a function in this module's namespace, args) of each call,
    in turn, in one process group (a group's start-up is paid once): their
    results."""
    return [globals()[name](*args) for name, args in calls]


class WordTokenizer:
    """A word-level tokenizer into the tiny vocabulary, the same ids in
    every process (crc32, not the salted ``hash``)."""

    def encode(self, text, add_special_tokens=False):
        return [3 + zlib.crc32(w.encode()) % 500
                for w in text.replace("\n", " \n ").split(" ") if w]


if __name__ == "__main__":
    from psalm_tpu_torch.train import train as ttrain
    state = ttrain.main(sys.argv[1:], tokenizer=WordTokenizer())
    print(f"rank {os.environ['RANK']} of {os.environ['WORLD_SIZE']}: "
          f"step {state.step}, group destroyed "
          f"{not dist.is_initialized()}", flush=True)
