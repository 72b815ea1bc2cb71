"""Training entry point: arguments, the train config, loss logging and the
``Trainer``.

Counterpart of ``psalm_tpu/train/train.py`` on one card (reference spec:
psalm/train/train.py, llava_trainer.py and scripts/train.sh): joint
multi-task training with task-homogeneous batches (panoptic / instance,
referring, region, mm_conv), lr 6e-5 cosine after a 3% warmup, bf16 compute
with f32 parameters, gradient checkpointing, checkpoints every
``save_steps`` keeping ``save_total_limit``, auto-resume, and per-component
loss logging with the last-nonzero fallback of
LLaVATrainer.compute_loss (llava_trainer.py:258-318) into
``train_log.jsonl`` and, with ``--report_to tensorboard``, as TensorBoard
scalars under ``output_dir/tb`` (the same tags and steps).
``--dataloader_num_workers`` > 0 draws the batches through
``data/prefetch.py``'s ``PrefetchLoader`` (the same batches, mapped ahead
on threads); ``--profile_steps a,b`` traces steps a..b with
``torch.profiler`` into a Chrome trace in ``output_dir``.

``main`` is the command line (``python -m psalm_tpu_torch.train.train
--output_dir ... --panoptic_json_path ...``, or under ``torchrun
--nproc_per_node=N -m psalm_tpu_torch.train.train ...``): the six dataset
classes from the paths with JAX's ``--data_ratio`` rule, a sampler shard per
data rank, the model
from ``--model_name_or_path`` (the port's released-format checkpoint
directory, ``models/builder.py``; random weights from ``--seed`` without
one) in f32 parameters with the compute type of ``--bf16``, on
``--device`` (the card unless the caller asks for the CPU). The config
comes from ``build_train_config(args)``, so the flags take effect (JAX's
``main`` builds ``PSALMConfig(seg_task=...)`` and hands it to its Trainer,
which then ignores ``--pixel_decoder_mode``, ``--window_point_radii``,
``--window_custom_vjp`` and ``--bf16``; ``ROADMAP.md``, Queue 3). Two
modes beyond JAX's flags: ``--train_backbone`` trains the Swin tower too
(K3's backward on the card, its drop path drawn from the step's
generator), and ``--lora_rank`` > 0 puts LoRA adapters on Phi's linears
and trains ``train/lora.py``'s ``psalm_finetune_mask`` (the adapters and
every module but the tower and Phi's base).

Distribution (``psalm_tpu/train/train.py``'s ``mesh``): ``Trainer(mesh=)``
takes a ``parallel.mesh.Mesh``. Each data rank steps on its rows of the
global batch, the criterion and ``llm_ce_loss`` return its share of the
global losses (global mask, entry and token counts, the global draws' rows),
``ZeroOptimizer`` sums the gradients over the data group and keeps Adam's
moments sharded over it, and with model > 1 ``lm_head`` and, when every
Phi linear is a float ``Dense``, Phi's decoder layers are tensor-parallel
(``PSALM(..., mesh=mesh)``; a LoRA, QLoRA, int8 or int4 Phi keeps its
layers whole on every model rank, as JAX's rules place it). The logged
losses are the global ones. A checkpoint is ``checkpoint.pt`` (rank 0: the whole
parameters, gathered over the model group, the step and the mesh's sizes)
and ``optimizer-{d}-{m}.pt`` (each rank's moment slices); one process
writes the same layout as a 1 x 1 mesh, and a resume re-slices the moments
for a mesh of any size, one process included. ``main`` under torchrun (``WORLD_SIZE``
> 1) builds a data-parallel mesh over every rank, shards the sampler by
data rank, and lets rank 0 alone write the log, the TensorBoard scalars and
the traces. The port writes ``torch.save`` files, not orbax
(``tools/orbax_to_torch.py`` converts JAX's).

Two differences from JAX's trainer, both on the mm_conv loss: the port runs
it with the tower frozen unless ``--train_backbone`` (JAX calls the model
with ``train=False`` there, so its tower always takes that loss's
gradient), and only that loss computes the
``lm_head`` logits (JAX computes them in every seg step too, where no loss
reads them: they get zero gradients, which leave them unchanged).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from psalm_tpu_torch.config import PSALMConfig, SegTask, config_from_json
from psalm_tpu_torch.data.constants import IGNORE_INDEX
from psalm_tpu_torch.data.datasets import (DataConfig, InstanceDataset,
                                           InteractiveDataset, MMConvDataset,
                                           PanopticDataset, ReferringDataset,
                                           SemanticDataset, UnifiedTaskSampler,
                                           collate)
from psalm_tpu_torch.models.psalm import PSALM, init_weights_
from psalm_tpu_torch.ops.sampling import UniformFn, default_uniform
from psalm_tpu_torch.parallel.mesh import (Mesh, all_reduce, shard_draws,
                                           shard_state_dict, shard_tensor,
                                           unshard)
from psalm_tpu_torch.train.criterion import PSALMCriterion
from psalm_tpu_torch.train.lora import psalm_finetune_mask
from psalm_tpu_torch.train.train_step import (TrainState, ZeroOptimizer,
                                              make_optimizer, train_step)

LOSS_KEYS = ["loss_mask", "loss_dice", "loss_SEG_class",
             "loss_class_name_class", "loss_region_class", "loss_llm"]

# batch keys that stay on the host
_HOST_KEYS = ("dataset_type", "num_class_names", "image_id", "file_name",
              "resized_hw", "original_hw")


def str2bool(text: str) -> bool:
    """A boolean flag's value, as HF's TrainingArguments take it: "True",
    "true" and "1" are true; "False", "false", "0" and "" are false;
    anything else is an error. (``type=bool`` would turn every non-empty
    string, "False" and "0" included, into True.)"""
    if text in ("True", "true", "1"):
        return True
    if text in ("False", "false", "0", ""):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def parse_args(argv=None):
    """psalm_tpu's training arguments, and ``--device``, ``--train_backbone``,
    ``--lora_rank`` and ``--lora_alpha``."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_name_or_path", default=None,
                   help="released-format PSALM checkpoint directory to "
                        "initialize from (models/builder.py; its "
                        "psalm_tpu_config.json, if any, is the base config); "
                        "random weights from --seed without one")
    p.add_argument("--mask2former_ckpt", default=None,
                   help="parsed and unused, as in psalm_tpu (a Mask2Former "
                        "Swin-B .pkl)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--panoptic_json_path", default=None,
                   help="COCO root with train2017/, panoptic_train2017/ and "
                        "annotations/panoptic_train2017.json")
    p.add_argument("--instance_json_path", default=None)
    p.add_argument("--semantic_json_path", default=None)
    p.add_argument("--semantic_label_folder", default=None)
    p.add_argument("--region_json_path", default=None)
    p.add_argument("--ref_coco_path", default=None)
    p.add_argument("--mmconv_path", default=None)
    p.add_argument("--image_folder", default=None)
    p.add_argument("--seg_task", default="panoptic")
    p.add_argument("--data_ratio", default="1||1||1||1",
                   help="panoptic/instance/semantic||region||referring||"
                        "mm_conv batch ratios")
    p.add_argument("--learning_rate", type=float, default=6e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--num_train_steps", type=int, default=100000)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--dataloader_num_workers", type=int, default=4,
                   help="mapper threads of the prefetching loader "
                        "(data/prefetch.py); 0 = synchronous")
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--save_steps", type=int, default=15000)
    p.add_argument("--save_total_limit", type=int, default=1)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--gradient_checkpointing", type=str2bool, default=True)
    p.add_argument("--bf16", type=str2bool, default=True)
    p.add_argument("--profile_steps", default=None,
                   help="e.g. '10,15': trace steps 10-15 with torch.profiler "
                        "into a Chrome trace in output_dir")
    p.add_argument("--report_to", default="none",
                   choices=["none", "tensorboard"],
                   help="'tensorboard' writes the logged scalars to "
                        "output_dir/tb (needs the tensorboard package)")
    p.add_argument("--tune_mm_mlp_adapter", type=str2bool, default=False,
                   help="stage-1 style: checkpoint only the mm_projector "
                        "(llava_trainer.py:231-256)")
    p.add_argument("--pixel_decoder_mode", default="deformable",
                   choices=["deformable", "window", "dense"],
                   help="'window' clamps the sampling offsets to "
                        "--window_radius pixels (K1 and K2 with a radius); "
                        "'dense' (kernel K5, 2 heads) replaces the sampler "
                        "with full attention over the encoder tokens")
    p.add_argument("--window_point_radii", default="",
                   help="per-point clamp radii for window mode, e.g. "
                        "'2,4,6,8' (one for each of enc_points; K1 and K2 "
                        "clamp point p at its own radius)")
    p.add_argument("--remat_pixel_decoder", type=int, default=-1,
                   help="1/0 = force pixel-decoder gradient checkpointing "
                        "on/off; -1 follows --gradient_checkpointing, except "
                        "window mode at batch 1 (JAX's measured policy)")
    p.add_argument("--window_custom_vjp", type=int, default=-1,
                   help="window mode: JAX's manual-VJP setting, which the "
                        "remat_pixel policy reads (the port's window "
                        "backward is K2 either way)")
    p.add_argument("--swin_type", default="base",
                   help="parsed and unused, as in psalm_tpu (the config's "
                        "Swin is Swin-B)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda unless asked)")
    p.add_argument("--train_backbone", type=str2bool, default=False,
                   help="train the Swin tower too (PSALM(train_backbone="
                        "True): K3's backward, drop path)")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="> 0: LoRA adapters of this rank on Phi's linears; "
                        "the adapters and every module but the tower and "
                        "Phi's base train (train/lora.py)")
    p.add_argument("--lora_alpha", type=float, default=16.0)
    return p.parse_args(argv)


class LossHistory:
    """Last-nonzero fallback logging (llava_trainer.py:258-318): alternating
    task batches zero out absent loss components; log the last seen value."""

    def __init__(self):
        self.hist: Dict[str, float] = {k: 0.0 for k in LOSS_KEYS}

    def update(self, metrics: Dict[str, Any]) -> Dict[str, float]:
        out = {}
        for k in LOSS_KEYS:
            v = float(metrics.get(k, 0.0))
            if v != 0.0:
                self.hist[k] = v
            out[k] = self.hist[k]
        out["loss"] = float(metrics.get("loss", 0.0))
        if "grad_norm" in metrics:
            out["grad_norm"] = float(metrics["grad_norm"])
        return out


def llm_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Shifted CE ignoring IGNORE_INDEX (llava_phi.py:1063-1073); with a
    mesh, this data rank's share: divided by the global token count."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    nll = -torch.gather(torch.log_softmax(shift_logits, -1), 2,
                        shift_labels.clamp(min=0)[..., None])[..., 0]
    count = valid.sum()
    if mesh is not None:
        count = all_reduce(count, mesh.data_group)
    return torch.sum(nll * valid) / count.clamp(min=1)


def build_train_config(args, base: Optional[PSALMConfig] = None
                       ) -> PSALMConfig:
    """PSALMConfig from CLI args (the reference's training_args -> cfg path,
    train.py:23-35), as ``psalm_tpu``'s builds it, on ``base`` (a
    checkpoint's own config; ``PSALMConfig()`` by default), with the LoRA
    rank and alpha of ``--lora_rank`` / ``--lora_alpha``."""
    cfg = (base or PSALMConfig()).replace(
        seg_task=SegTask(args.seg_task),
        compute_dtype="bfloat16" if args.bf16 else "float32")
    rank = int(getattr(args, "lora_rank", 0))
    if rank > 0:
        cfg = cfg.replace(phi=dataclasses.replace(
            cfg.phi, lora_rank=rank,
            lora_alpha=float(getattr(args, "lora_alpha", 16.0))))
    mode = getattr(args, "pixel_decoder_mode", "deformable")
    if mode != "deformable":
        kw = dict(attention_mode=mode)
        if mode == "window":
            # training headroom: offsets grow past the init magnitude and no
            # runtime radius guard exists inside a train step
            kw["window_radius"] = float(getattr(args, "window_radius", 8.0))
            ppr = getattr(args, "window_point_radii", "")
            if ppr:
                kw["window_point_radii"] = tuple(
                    float(r) for r in str(ppr).split(","))
            kw["window_scan_tiles"] = False
            kw["window_custom_vjp"] = int(getattr(args, "window_custom_vjp",
                                                  -1)) != 0
            kw["window_head_chunk"] = 1
        if mode == "dense":
            kw["transformer_nheads"] = 2
        cfg = cfg.replace(pixel_decoder=dataclasses.replace(
            cfg.pixel_decoder, **kw))
    return cfg


def remat_pixel_policy(args, cfg: PSALMConfig) -> Optional[bool]:
    """``remat_pixel`` for PSALM (``psalm_tpu/train/train.py:195-211``):
    --remat_pixel_decoder 1/0 forces it; by default (-1) the window mode's
    manual VJP at per-card batch 1 skips it (JAX's measured best: that VJP
    keeps only the op's inputs), and otherwise it follows
    --gradient_checkpointing (None)."""
    rp = int(getattr(args, "remat_pixel_decoder", -1))
    if rp >= 0:
        return rp == 1
    if cfg.pixel_decoder.window_custom_vjp and \
            getattr(args, "per_device_train_batch_size", 1) <= 1:
        return False
    return None


def _checkpoints(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    return sorted((d for d in os.listdir(output_dir)
                   if d.startswith("checkpoint-")),
                  key=lambda d: int(d.split("-")[1]))


def trainable_mask(model: PSALM) -> Dict[str, bool]:
    """Which parameters a Trainer trains: every one but the frozen vision
    tower's; with LoRA (``cfg.phi.lora_rank`` > 0) ``psalm_finetune_mask``'s
    (the adapters and every module but the tower and Phi's base); the
    tower's too when ``model.train_backbone``."""
    names = [n for n, _ in model.named_parameters()]
    if model.cfg.phi.lora_rank > 0:
        mask = psalm_finetune_mask(names)
    else:
        mask = {n: not n.startswith("model.vision_tower.") for n in names}
    if model.train_backbone:
        mask.update({n: True for n in names
                     if n.startswith("model.vision_tower.")})
    return mask


class Trainer:
    """Trains ``model`` (a PSALM built here from ``cfg`` with random
    weights drawn from ``args.seed`` when none is given) on ``device``.
    ``uniform_fn`` replaces the criterion's point draws (the tests inject
    JAX's). The optimizer takes ``trainable_mask``'s parameters; the others
    are frozen (``requires_grad_(False)``) and get no optimizer state.

    ``mesh``: data (and tensor) parallelism on ``mesh.device`` (see the
    module docstring); every rank builds the same random weights, and with
    model > 1 keeps its slices. A given model must then be built with
    ``PSALM(..., mesh=mesh)``."""

    def __init__(self, args, cfg: Optional[PSALMConfig] = None,
                 model: Optional[PSALM] = None, device="cuda",
                 uniform_fn: UniformFn = default_uniform,
                 mesh: Optional[Mesh] = None):
        self.args = args
        self.cfg = cfg if cfg is not None else build_train_config(args)
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        tp = mesh is not None and mesh.model > 1
        if model is None:
            kw = dict(dtype=torch.bfloat16 if args.bf16 else torch.float32,
                      device=self.device, remat=args.gradient_checkpointing,
                      remat_pixel=remat_pixel_policy(args, self.cfg),
                      train_backbone=getattr(args, "train_backbone", False))
            model = init_weights_(PSALM(self.cfg, **kw),
                                  torch.Generator(device=self.device)
                                  .manual_seed(args.seed))
            if tp:
                full = model.state_dict()
                model = PSALM(self.cfg, mesh=mesh, **kw)
                model.load_state_dict(shard_state_dict(full, mesh, self.cfg))
                del full
        elif tp and model.mesh is None:
            raise ValueError("with model > 1 the Trainer takes a model built "
                             "with PSALM(..., mesh=mesh) holding "
                             "shard_state_dict's slices")
        self.model = model.train()
        if mesh is not None:  # the drop path's draws of the global batch
            tower = self.model.model.vision_tower
            tower.uniform_fn = shard_draws(tower.uniform_fn, mesh)
        self.criterion = PSALMCriterion(self.cfg.loss,
                                        self.cfg.mask_decoder.num_queries,
                                        uniform_fn=uniform_fn, mesh=mesh)
        mask = trainable_mask(self.model)
        self.trainable = []
        for n, p in self.model.named_parameters():
            p.requires_grad_(mask[n])
            if mask[n]:
                self.trainable.append((n, p))
        if mesh is None:
            self.optimizer = make_optimizer(
                [p for _, p in self.trainable], args.learning_rate,
                args.num_train_steps, args.warmup_ratio, args.weight_decay,
                names=[n for n, _ in self.trainable])
        else:
            self.optimizer = ZeroOptimizer(
                self.trainable, mesh, self.cfg, args.learning_rate,
                args.num_train_steps, args.warmup_ratio, args.weight_decay)
        # the one process, or the rank that writes logs and traces
        self.rank_zero = mesh is None or mesh.rank == 0
        self.state = TrainState(0, self.model, self.optimizer)
        self.generator = torch.Generator(device=self.device).manual_seed(
            args.seed)
        self.history = LossHistory()

    # -- loss functions per task kind ---------------------------------------

    def _seg_loss_fn(self, task_kwargs):
        def loss_fn(batch, generator):
            out = self.model(batch, train=True, generator=generator,
                             **task_kwargs)
            targets = {"masks": batch["gt_masks"], "labels": batch["gt_labels"],
                       "valid": batch["gt_valid"]}
            losses = self.criterion(
                generator, out, targets,
                compute_seg=task_kwargs.get("use_seg_embedding", False),
                compute_class=task_kwargs.get("use_class_names", False),
                compute_region=task_kwargs.get("use_regions", False))
            # the reference uses mask losses only for seg batches
            # (llava_phi.py:1133-1136)
            return losses["loss_total"], losses
        return loss_fn

    def _mm_conv_loss_fn(self):
        # no generator: a training tower runs deterministically here, as
        # JAX's train=False call runs it
        def loss_fn(batch, generator):
            out = self.model(batch, use_class_names=False, train=True,
                             compute_logits=True)
            loss = llm_ce_loss(out["logits"], batch["labels"], self.mesh)
            return loss, {"loss_llm": loss.detach()}
        return loss_fn

    def _step_for(self, dataset_type: str, num_class_names: int):
        """The loss function of a batch of ``dataset_type``."""
        if dataset_type == "mm_conv":
            return self._mm_conv_loss_fn()
        if dataset_type == "referring_coco":
            return self._seg_loss_fn(dict(use_seg_embedding=True,
                                          use_class_names=False))
        if dataset_type == "region_coco":
            return self._seg_loss_fn(dict(use_regions=True,
                                          use_class_names=False))
        # panoptic / instance
        return self._seg_loss_fn(dict(use_class_names=True,
                                      num_class_names=num_class_names))

    def stage(self, batch_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The collated numpy batch as tensors on the device (the host-only
        keys dropped)."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     non_blocking=True)
                for k, v in batch_np.items() if k not in _HOST_KEYS}

    def step(self, batch_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One training step on a collated batch; returns its metrics (with
        a mesh, the global ones: the ranks' shares summed)."""
        dataset_type = batch_np["dataset_type"]
        num_k = int(np.asarray(batch_np.get("num_class_names", [0]))[0])
        if self.mesh is not None:  # one class-name count on every rank
            num_k = int(all_reduce(torch.tensor(num_k, device=self.device),
                                   self.mesh.data_group, dist.ReduceOp.MAX))
        loss_fn = self._step_for(dataset_type, num_k)
        metrics = train_step(self.state, loss_fn, self.stage(batch_np),
                             self.generator)
        if self.mesh is None:
            return metrics
        keys = [k for k in metrics if k != "grad_norm"]
        total = all_reduce(torch.stack([metrics[k].float() for k in keys]),
                           self.mesh.data_group)
        return {**dict(zip(keys, total.unbind())),
                "grad_norm": metrics["grad_norm"]}

    # -- checkpointing -------------------------------------------------------

    def save(self, step: int) -> str:
        """``output_dir/checkpoint-{step}/``: ``checkpoint.pt`` (the
        trainable parameters, only the projector with
        --tune_mm_mlp_adapter, whole: gathered over the model group; the
        step; the mesh's sizes, 1 x 1 without one) and this rank's moment
        slices in ``optimizer-{data_rank}-{model_rank}.pt``; then keeps the
        newest ``save_total_limit``. With a mesh every rank calls it."""
        path = os.path.join(self.args.output_dir, f"checkpoint-{step}")
        os.makedirs(path, exist_ok=True)
        adapter = getattr(self.args, "tune_mm_mlp_adapter", False)
        m, opt = self.mesh, self.optimizer
        params = {n: p.detach() if m is None
                  else unshard(p.detach(), n, m, self.cfg)
                  for n, p in self.trainable
                  if not adapter or n.startswith("model.mm_projector.")}
        if not adapter:
            torch.save(opt.state_dict(), os.path.join(
                path, f"optimizer-{opt.data_rank}-{opt.model_rank}.pt"))
        if self.rank_zero:
            torch.save({"params": params, "step": step,
                        "world": {"data": opt.data, "model": opt.model}},
                       os.path.join(path, "checkpoint.pt"))
        if m is not None:
            dist.barrier()
        if self.rank_zero:
            for d in _checkpoints(self.args.output_dir)[
                    :-self.args.save_total_limit]:
                shutil.rmtree(os.path.join(self.args.output_dir, d))
        return path

    def latest_checkpoint(self) -> Optional[str]:
        ckpts = _checkpoints(self.args.output_dir)
        return os.path.join(self.args.output_dir, ckpts[-1]) if ckpts else None

    def try_resume(self) -> int:
        """Loads the newest checkpoint, if any (train.py:459-462), saved on a
        mesh of any size or by one process; returns the step to go on
        from."""
        path = self.latest_checkpoint()
        if path is None:
            return self.state.step
        payload = torch.load(os.path.join(path, "checkpoint.pt"),
                             map_location=self.device)
        m, opt = self.mesh, self.optimizer
        params = dict(self.trainable)
        with torch.no_grad():
            for n, t in payload["params"].items():
                params[n].copy_(t if m is None
                                else shard_tensor(t, n, m, self.cfg))
        opt.refresh()
        if not getattr(self.args, "tune_mm_mlp_adapter", False):
            world = payload["world"]
            if (world["data"], world["model"]) == (opt.data, opt.model):
                files = [f"optimizer-{opt.data_rank}-{opt.model_rank}.pt"]
            else:
                files = sorted(f for f in os.listdir(path)
                               if f.startswith("optimizer-"))
            opt.load_state_dict(
                [torch.load(os.path.join(path, f), map_location="cpu")
                 for f in files])
        self.state.step = int(payload["step"])
        if self.rank_zero:
            print(f"resumed from {path} at step {self.state.step}")
        return self.state.step

    # -- main loop -----------------------------------------------------------

    def train(self, sampler: UnifiedTaskSampler) -> TrainState:
        """Steps from the last checkpoint (or 0) to ``num_train_steps``,
        batches drawn from ``sampler`` and collated: through a
        ``PrefetchLoader`` with ``dataloader_num_workers`` > 0, else in
        turn."""
        args = self.args
        start_step = self.try_resume()
        os.makedirs(args.output_dir, exist_ok=True)
        n_workers = getattr(args, "dataloader_num_workers", 0)
        loader = None
        if n_workers > 0:
            from psalm_tpu_torch.data.prefetch import PrefetchLoader
            loader = PrefetchLoader(sampler, collate, num_workers=n_workers,
                                    num_batches=args.num_train_steps
                                    - start_step)
        tb_writer = None
        try:
            if getattr(args, "report_to", "none") == "tensorboard" and \
                    self.rank_zero:
                tb_writer = summary_writer(os.path.join(args.output_dir, "tb"))
            self._train_loop(loader, sampler, tb_writer, start_step)
        finally:
            if loader is not None:
                loader.close()
            if tb_writer is not None:
                tb_writer.close()
        self.save(args.num_train_steps)
        return self.state

    def _train_loop(self, loader, sampler, tb_writer, start_step: int):
        args = self.args
        log_path = os.path.join(args.output_dir, "train_log.jsonl")
        profile_range = (tuple(int(s) for s in args.profile_steps.split(","))
                         if getattr(args, "profile_steps", None) else None)
        profiler = None
        t0 = time.time()
        try:
            for step in range(start_step, args.num_train_steps):
                batch_np = (next(loader) if loader is not None
                            else collate(sampler.next_batch()))
                if profile_range and step == profile_range[0] and \
                        self.rank_zero:
                    profiler = self._start_profiler()
                metrics = self.step(batch_np)
                if profiler is not None and step == profile_range[1]:
                    self._stop_profiler(profiler, profile_range)
                    profiler = None
                if step % args.logging_steps == 0 and self.rank_zero:
                    logged = self.history.update(
                        {k: float(v) for k, v in metrics.items()})
                    logged.update(step=step,
                                  dataset_type=batch_np["dataset_type"],
                                  steps_per_sec=(step - start_step + 1)
                                  / (time.time() - t0))
                    print(json.dumps(logged))
                    with open(log_path, "a") as f:
                        f.write(json.dumps(logged) + "\n")
                    if tb_writer is not None:
                        for k, v in logged.items():
                            if isinstance(v, (int, float)):
                                tb_writer.add_scalar(k, v, global_step=step)
                if step > 0 and step % args.save_steps == 0:
                    self.save(step)
        finally:
            if profiler is not None:  # the run ended inside the range
                self._stop_profiler(profiler, profile_range)

    def _start_profiler(self):
        """torch.profiler over the CPU and, on the card, CUDA activities
        (``jax.profiler.start_trace``'s counterpart)."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profiler(self, profiler, profile_range) -> str:
        """Waits for the device, as JAX blocks on the step's metrics before
        ``stop_trace``, and writes the Chrome trace
        ``output_dir/trace_steps_{a}_{b}.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        path = os.path.join(self.args.output_dir, "trace_steps_%d_%d.json"
                            % profile_range)
        profiler.export_chrome_trace(path)
        print(f"profiler trace of steps {profile_range[0]}-"
              f"{profile_range[1]} written to {path}")
        return path


def summary_writer(log_dir: str):
    """``torch.utils.tensorboard.SummaryWriter`` on ``log_dir``; an
    ``ImportError`` that names the package when tensorboard is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError("--report_to tensorboard needs the tensorboard "
                          f"package, which does not import: {e}") from e
    return SummaryWriter(log_dir=log_dir)


def build_datasets(args, tokenizer, dcfg: DataConfig):
    """The dataset of each path given, with its ``--data_ratio`` share
    (``psalm_tpu/train/train.py::main``'s rule: panoptic, instance and
    semantic take the first ratio, region the second, referring the third,
    mm_conv the fourth). Returns (datasets, ratios)."""
    datasets, ratios = [], []
    ratio_vals = [int(r) for r in args.data_ratio.split("||")]
    if args.panoptic_json_path:
        datasets.append(PanopticDataset(args.panoptic_json_path, tokenizer,
                                        dcfg, shuffle_classes=True))
        ratios.append(ratio_vals[0] if ratio_vals else 1)
    if args.instance_json_path:
        datasets.append(InstanceDataset(args.instance_json_path,
                                        args.image_folder, tokenizer, dcfg))
        ratios.append(ratio_vals[0] if ratio_vals else 1)
    if args.semantic_json_path:
        datasets.append(SemanticDataset(args.semantic_json_path,
                                        args.image_folder,
                                        args.semantic_label_folder,
                                        tokenizer, dcfg))
        ratios.append(ratio_vals[0] if ratio_vals else 1)
    if args.region_json_path:
        datasets.append(InteractiveDataset(args.region_json_path,
                                           args.image_folder, tokenizer, dcfg))
        ratios.append(ratio_vals[min(1, len(ratio_vals) - 1)])
    if args.ref_coco_path:
        datasets.append(ReferringDataset(args.ref_coco_path, args.image_folder,
                                         tokenizer, dcfg))
        ratios.append(ratio_vals[min(2, len(ratio_vals) - 1)])
    if args.mmconv_path:
        datasets.append(MMConvDataset(args.mmconv_path, args.image_folder,
                                      tokenizer, dcfg))
        ratios.append(ratio_vals[min(3, len(ratio_vals) - 1)])
    if not datasets:
        raise ValueError("no training data: give at least one of the "
                         "--*_json_path, --ref_coco_path or --mmconv_path")
    return datasets, ratios


def main(argv=None, tokenizer=None) -> TrainState:
    """The training command line (``psalm_tpu/train/train.py::main``).
    ``tokenizer``: the one the datasets encode with (the tests inject one);
    without it, ``transformers.AutoTokenizer`` from
    ``--model_name_or_path`` with "[SEG]" added."""
    args = parse_args(argv)
    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path)
        tokenizer.add_tokens("[SEG]")
    base = None
    if args.model_name_or_path:
        cfg_path = os.path.join(args.model_name_or_path,
                                "psalm_tpu_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                base = config_from_json(f.read())
    cfg = build_train_config(args, base)
    dcfg = DataConfig(image_size=cfg.image_size,
                      num_image_tokens=(cfg.image_size // 64) ** 2,
                      num_seg_queries=cfg.mask_decoder.num_queries,
                      pad_len=args.model_max_length)
    datasets, ratios = build_datasets(args, tokenizer, dcfg)
    mesh, device, shard = None, args.device, (0, 1)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # torchrun: data parallelism over every rank (JAX's
        # process_count() > 1 branch, psalm_tpu/train/train.py:453-460)
        from psalm_tpu_torch.parallel.mesh import (host_shard_info,
                                                   init_distributed,
                                                   make_mesh)
        init_distributed(args.device)
        mesh = make_mesh(data=-1, model=1, device=args.device)
        device, shard = mesh.device, host_shard_info(mesh)
    try:
        sampler = UnifiedTaskSampler(
            datasets, args.per_device_train_batch_size, ratios,
            seed=args.seed, shard_index=shard[0], num_shards=shard[1])
        model = None
        if args.model_name_or_path:
            from psalm_tpu_torch.models.builder import load_pretrained_model
            _, model, _ = load_pretrained_model(
                args.model_name_or_path, cfg=cfg,
                dtype=torch.bfloat16 if args.bf16 else torch.float32,
                param_dtype=torch.float32, device=device,
                lora_seed=args.seed, remat=args.gradient_checkpointing,
                remat_pixel=remat_pixel_policy(args, cfg),
                train_backbone=args.train_backbone)
        return Trainer(args, cfg, model=model, device=device,
                       mesh=mesh).train(sampler)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
