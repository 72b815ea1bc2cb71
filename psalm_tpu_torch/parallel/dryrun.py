"""The multi-card dry run: one tiny data- and tensor-parallel training step
and one data-parallel eval step.

Counterpart of ``__graft_entry__.dryrun_multichip`` (:114) and its
``_dryrun_eval_impl`` (:209): on n ranks, model 2 when n is even and above
1, data n // model; the tiny config in window mode with the manual VJP (the
training configuration of JAX's dry run); one panoptic sample per data rank
with 4 padded target masks; a ``Trainer(mesh=)`` step that must find Phi's
q/k/v split over 'model' and Adam's moments split over 'data', then an
``EvalRunner(mesh=)`` batch of one image per data rank with non-square
content and original sizes, whose maps must be finite and whole on every
rank.

``dryrun_multichip(n, "cpu")`` spawns n gloo processes
(``parallel/launch.py``); ``"cuda"`` needs n cards (NCCL, one process per
card) and raises with fewer. n = 1 runs in this process, in its process
group if one is initialized (at world size 1), else in one it makes and
destroys.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from psalm_tpu_torch.parallel.launch import spawn
from psalm_tpu_torch.parallel.mesh import (init_distributed, local_rows,
                                           make_mesh)


def dryrun_multichip(n: int, device: str = "cuda") -> List[Dict[str, Any]]:
    """The dry run on n ranks of ``device``; every rank's summary."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}, {device!r}) needs {n} "
                           f"cards; this machine has "
                           f"{torch.cuda.device_count()}")
    if n > 1:
        return spawn("psalm_tpu_torch.parallel.dryrun:dryrun_rank", n,
                     (device,), device=device)
    made = not dist.is_initialized()
    if made:
        init_distributed(device)
    elif dist.get_world_size() != 1:
        raise RuntimeError("dryrun_multichip(1) inside a process group of "
                           f"{dist.get_world_size()}")
    try:
        return [dryrun_rank(device)]
    finally:
        if made:
            dist.destroy_process_group()


def _train_args(device: str):
    from psalm_tpu_torch.train.train import parse_args
    return parse_args(["--output_dir", "unused", "--device", device,
                       "--pixel_decoder_mode", "window", "--bf16", "false",
                       "--gradient_checkpointing", "false",
                       "--num_train_steps", "10",
                       "--per_device_train_batch_size", "1", "--seed", "0"])


def dryrun_rank(device: str) -> Dict[str, Any]:
    """One rank of the dry run (in a process group of any size)."""
    from psalm_tpu_torch.config import tiny_test_config
    from psalm_tpu_torch.eval.runner import synthetic_panoptic_batch
    from psalm_tpu_torch.train.train import Trainer, build_train_config
    n = dist.get_world_size()
    model_par = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(data=n // model_par, model=model_par, device=device)
    args = _train_args(device)
    cfg = build_train_config(args, tiny_test_config())
    K, B, s = 4, mesh.data, cfg.image_size  # a sample per data rank
    batch = synthetic_panoptic_batch(cfg, B, K, (s, s), (s, s), seed=0)
    rng = np.random.default_rng(1)
    batch["gt_masks"] = (rng.uniform(size=(B, 4, s, s)) > 0.7
                         ).astype(np.float32)
    batch["gt_labels"] = rng.integers(0, K - 1, (B, 4)).astype(np.int32)
    batch["gt_valid"] = np.tile([True, True, True, False], (B, 1))
    batch["num_class_names"] = np.full(B, K)
    batch["dataset_type"] = "panoptic_coco"

    trainer = Trainer(args, cfg, mesh=mesh)
    q = trainer.model.model.layers[0].self_attn.q_proj.weight
    tp_live = q.shape[0] * model_par == cfg.phi.hidden_size
    opt = trainer.optimizer
    split = [name for name, shard, p in zip(opt.names, opt.shards,
                                            opt.params)
             if shard.shape != p.shape]
    if model_par > 1 and not tp_live:
        raise AssertionError("Phi's q_proj is not split over 'model'")
    if mesh.data > 1 and not split:
        raise AssertionError("no Adam moment is split over 'data'")
    metrics = {k: float(v) for k, v in
               trainer.step(local_rows(batch, mesh)).items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    out = _dryrun_eval(trainer.model.eval(), cfg, mesh, K)
    return {"rank": mesh.rank, "data": mesh.data, "model": mesh.model,
            "metrics": metrics, "tp_live": tp_live,
            "moments_split": len(split), **out}


def _dryrun_eval(model, cfg, mesh, K) -> Dict[str, Any]:
    """One data-parallel eval batch, an image per data rank, each with its
    own non-square content and original size (JAX's geometry)."""
    from psalm_tpu_torch.eval.runner import (EvalRunner,
                                             synthetic_panoptic_batch)
    B, s = mesh.data, cfg.image_size
    batch = synthetic_panoptic_batch(cfg, B, K, (s, s), (s, s), seed=2)
    rh, oh = [], []
    for b in range(B):
        nh, nw = s - 8 - 4 * (b % 2), s - 4 * (b % 3)
        batch["padding_mask"][b] = True
        batch["padding_mask"][b, :nh, :nw] = False
        rh.append((nh, nw))
        oh.append((nh - 2, nw - 2))
    batch["resized_hw"] = np.asarray(rh)
    batch["original_hw"] = np.asarray(oh)
    runner = EvalRunner(model, cfg, num_class_names=K,
                        bucket_hw=(s, s), mesh=mesh)
    out = runner.infer(batch)
    if len(out["panoptic_seg"]) != B or any(
            m.shape != tuple(o) for m, o in zip(out["panoptic_seg"], oh)):
        raise AssertionError("the eval maps are not the batch's")
    sem = np.concatenate([np.asarray(m, np.float64).ravel()
                          for m in out["sem_seg"]])
    if not np.isfinite(sem).all():
        raise AssertionError("non-finite semantic maps")
    return {"images": B,
            "segments": int(np.asarray(out["segments"]["valid"]).sum()),
            "panoptic_seg": [np.asarray(m) for m in out["panoptic_seg"]]}
