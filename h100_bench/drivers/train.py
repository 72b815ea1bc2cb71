"""Training cells: ``Trainer.step`` of the port, steps back to back on a
pool of seeded batches, on one card or data-parallel over several (one
process a card, NCCL, ``Trainer(mesh=make_mesh(n, 1))`` with ZeRO-sharded
moments: the pattern of the port's ``tools/dist_step_time.py``).

Set-up builds one trainer (the configuration's recipe: bf16 compute, f32
parameters, AdamW with the warmup-cosine schedule, gradient checkpointing,
the frozen tower, the port's default scipy matcher) with the seed's weights
and the benchmark's point draws (``gen/batches.py::Draws``), and drives it
through its first three steps on distinct batches through the window's own
call. Those steps warm every shape and give what the check compares: each
step's loss, the first gradient's norm per parameter (from AdamW's first
moment after one step, m = (1 - beta1) g), and the norm of each
parameter's change after the three. The window (``--trace 0``) then steps
for ``--seconds`` (rank 0 decides when to stop and tells the others over a
gloo group after each step); the rate is all ranks' samples over the
window. ``--trace 1`` traces ``trace_steps`` steps on every rank.

After the window the program is freed and the reference (``reference/``,
f32, TF32 off) follows the same three steps from the same weights, batches
and draws, data-parallel over the same ranks where the cell has several:
each rank its rows, the counts and gradients summed over the group with
``torch.distributed``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import socket
import sys
import time
from datetime import timedelta
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from h100_bench import weights
from h100_bench.gen import batches

CHECK_STEPS = 3
BETA1 = 0.9
# host-side keys of a collated batch (the port's trainer's _HOST_KEYS)
HOST_KEYS = ("dataset_type", "num_class_names", "image_id", "file_name",
             "resized_hw", "original_hw")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(ctx):
    """(device, gloo group or None): this rank's card (``ctx.device``, the
    CPU in the tests, where given), and for a cell of several ranks the
    process group (NCCL on cards, gloo on the CPU) and a gloo group for
    the host's stop flag."""
    ranks = ctx.mix["data_ranks"]
    device = ctx.device if ctx.device is not None \
        else torch.device("cuda", ctx.rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if ranks == 1:
        return device, None
    os.environ["LOCAL_RANK"] = str(ctx.rank)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{ctx.port}",
                            rank=ctx.rank, world_size=ranks,
                            timeout=timedelta(seconds=150))
    return device, dist.new_group(backend="gloo")


def train_args(config, mix) -> argparse.Namespace:
    """The port's training arguments (``train.parse_args``'s names) of the
    configuration's recipe and the mix's per-card batch."""
    t = config["train"]
    return argparse.Namespace(
        output_dir="", learning_rate=t["learning_rate"],
        warmup_ratio=t["warmup_ratio"], weight_decay=t["weight_decay"],
        num_train_steps=t["num_train_steps"],
        per_device_train_batch_size=mix["batch"], save_steps=10 ** 9,
        save_total_limit=1, logging_steps=1,
        gradient_checkpointing=t["gradient_checkpointing"],
        bf16=config["compute_dtype"] == "bfloat16", seed=0,
        seg_task="panoptic", pixel_decoder_mode=t["pixel_decoder_mode"])


def build_trainer(config, mix, seed: int, device, draws):
    from psalm_tpu_torch.config import config_from_json
    from psalm_tpu_torch.models.psalm import PSALM
    from psalm_tpu_torch.parallel.mesh import make_mesh
    from psalm_tpu_torch.train.criterion import set_assign_impl
    from psalm_tpu_torch.train.train import (Trainer, build_train_config,
                                             remat_pixel_policy)
    args = train_args(config, mix)
    cfg = build_train_config(args, config_from_json(json.dumps(
        config["model"])))
    set_assign_impl(config["train"]["matcher"])
    model = PSALM(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                  device=device, remat=args.gradient_checkpointing,
                  remat_pixel=remat_pixel_policy(args, cfg))
    spec, meta = weights.weight_spec(config)
    weights.fill(model, spec, seed, torch.float32, reference=meta)
    ranks = mix["data_ranks"]
    mesh = make_mesh(ranks, 1, device=str(device)) if ranks > 1 else None
    return Trainer(args, cfg, model=model, device=device, uniform_fn=draws,
                   mesh=mesh)


def install_spans(spans) -> None:
    from psalm_tpu_torch.models import swin
    from psalm_tpu_torch.ops import msdeform

    from h100_bench.counts import ops
    spans.wrap(msdeform, "_launch_bwd", "msdeform_bwd", ops.msdeform_bwd_bound)
    spans.wrap(swin, "window_attention", "swin_attn",
               ops.window_attention_bound)


def first_gradients(optimizer, ranks: int) -> Dict[str, Any]:
    """Each parameter's gradient as AdamW got it at the first step, from
    its first moment m = (1 - beta1) g, on the host: (g, axis), where
    ``axis`` is that of this rank's ZeRO slice on a cell of several ranks
    (None: the whole parameter)."""
    out = {}
    for n, s, axis in zip(optimizer.names, optimizer.shards, optimizer.axes):
        m = optimizer.adamw.state.get(s, {}).get("exp_avg")  # none: no step
        g = (m.float() / (1 - BETA1) if m is not None
             else torch.zeros(s.shape, device=s.device))
        out[n] = (g.to("cpu"), axis if ranks > 1 else None)
    return out


def gather(value, group, ranks: int) -> List[Any]:
    if ranks == 1:
        return [value]
    out = [None] * ranks
    dist.all_gather_object(out, value, group=group)
    return out


def run(ctx) -> Dict[str, Any]:
    from h100_bench.common import Spans, Trace, profile_window, read_metrics
    from h100_bench.counts.ops import peaks
    mix, config, seed = ctx.mix, ctx.config, ctx.seed
    ranks = mix["data_ranks"]
    device, flags = init_group(ctx)
    trainer = build_trainer(config, mix, seed, device,
                            batches.Draws(seed, device))
    S = trainer.cfg.image_size
    nq = trainer.cfg.mask_decoder.num_queries
    pool = [batches.train_batch(mix, S, nq, seed, i, ctx.rank, ranks)
            for i in range(mix["pool_batches"])]
    # the first three steps: warm-up, and what the check compares (on the
    # host: the first gradient; on rank 0, each parameter's change)
    delta = ({n: p.detach().to("cpu", copy=True) for n, p in trainer.trainable}
             if ctx.rank == 0 else None)
    losses, grads = [], None
    for i in range(CHECK_STEPS):
        metrics = trainer.step(pool[i])
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = first_gradients(trainer.optimizer, ranks)
    if ctx.rank == 0:
        for n, p in trainer.trainable:
            torch.sub(p.detach().to("cpu"), delta[n], out=delta[n])
    program = {"loss": losses, "grad": grads, "delta": delta}
    del delta
    spans = Spans(peaks())
    if ctx.trace:
        install_spans(spans)
        spans.recording = True
    ctx.mark_setup_done()

    def step(n: int):
        trainer.step(pool[(CHECK_STEPS + n) % len(pool)])

    def go_on(t0) -> bool:
        stop = torch.tensor([time.perf_counter() - t0 >= ctx.seconds])
        if flags is not None:
            dist.broadcast(stop, 0, group=flags)
        return not bool(stop.item())

    steps = 0
    if ctx.trace:
        with profile_window() as prof:
            t0 = time.perf_counter()
            for steps in range(mix["trace_steps"]):
                step(steps)
            ctx.sync()
            window = time.perf_counter() - t0
        steps = mix["trace_steps"]
    else:
        t0 = time.perf_counter()
        ends = []
        while True:
            step(steps)
            steps += 1
            ends.append(time.perf_counter() - t0)
            if not go_on(t0):
                break
        ctx.sync()
        window = time.perf_counter() - t0
        gaps = [b - a for a, b in zip([0.0] + ends, ends)]
        thirds = [gaps[i * len(gaps) // 3:(i + 1) * len(gaps) // 3]
                  for i in range(3)]
        if ctx.rank == 0:
            print("step s: median %.4f max %.4f; thirds %s" % (
                sorted(gaps)[len(gaps) // 2], max(gaps),
                [round(sum(t) / max(len(t), 1), 4) for t in thirds]),
                file=sys.stderr)
    ctx.window_closed()
    spans.recording = False
    spans.remove()
    samples = steps * mix["batch"] * ranks
    out: Dict[str, Any] = {"attempted": samples, "window_s": window,
                           "failed": 0}
    peak = gather(ctx.memory_peak(), flags, ranks)
    out["memory_peak_bytes"] = max(peak)
    if ctx.trace:
        trace = Trace(prof, window, {"samples": samples, "steps": steps,
                                     "flops": ctx.counts["flops"] * samples},
                      spans.totals, chips=ranks)
        busy = gather(trace.busy_s, flags, ranks)
        trace.busy_s = sum(busy) / ranks  # averaged over the cards
        out["per_layer"] = read_metrics(ctx.per_layer_names, trace)
        out["busy_s"], out["breakdown"] = trace.busy_s, trace.breakdown()
        del prof, trace
    else:
        out["end_to_end"] = {"train_samples_per_s": samples / window}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_steps(config, mix, seed, pool, device, ctx.rank,
                          judged=[program])
    del program
    out["check_s"] = time.perf_counter() - t0
    out["checks"], out["detail"] = [], {}
    if ctx.rank == 0:
        out["checks"] = compare(ref["judged"][0], ref["own"], ctx.limits)
        out["detail"] = {"program": ref["judged"][0], "reference": ref["own"]}
    if flags is not None:
        dist.barrier(group=flags)
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# the reference's three steps and the comparison


def schedule(lr: float, total: int, ratio: float):
    """A copy of the port's ``train_step.warmup_cosine_schedule``: the
    learning rate of update ``count`` (0 for the first)."""
    warmup = max(int(total * ratio), 1)
    decay = total - warmup

    def at(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))
    return at


class _Group:
    """The reference criterion's data group: ``data`` ranks of the default
    group, this rank's place among them."""

    def __init__(self, ranks: int, rank: int):
        self.data, self.data_rank, self.data_group = ranks, rank, None


#: an element of a parameter counts in its change where its reference
#: gradient is at least this share of the parameter's root mean square
#: gradient; a parameter counts where its gradient's norm is at least this
#: share of the median parameter's (``moved``)
KEEP = 1e-3


def reference_steps(config, mix, seed: int, pool, device, rank: int,
                    judged=(), lower=None, rows=None, exchange: bool = True,
                    record: bool = False) -> Dict[str, Any]:
    """The reference's first three steps on the pool's first batches.

    ``own``: each step's loss, each parameter's first gradient norm and the
    norm of its change after the three, over the elements that ``KEEP``
    keeps (an element whose gradient is nought to rounding moves under Adam
    by round-off alone: the key bias's dimensions that no rotary embedding
    turns, under softmax). ``judged``: each record of a program's three
    steps (``run``'s: losses, first gradients and changes on the host) read
    against this reference: its losses, and per parameter its first
    gradient's norm, the norm of its difference from the reference's
    (``grad_diff``) and its change's norm over the same elements.
    ``record``: also this reference's own record, to be judged by another
    (a control's or a fault's).

    ``lower``: the control's float8 type; ``rows``: only this many rows of
    each rank's batch (a fault: part of the batch left out); ``exchange``
    False: the gradients are not summed over the ranks (a fault)."""
    from h100_bench.reference import layers
    from h100_bench.reference.criterion import PSALMCriterion
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks = mix["data_ranks"]
    t = config["train"]
    cfg = weights.reference_config(config)
    spec, meta = weights.weight_spec(config)
    model = weights.reference_model(cfg, device,
                                    remat=t["gradient_checkpointing"])
    weights.fill(model, spec, seed, torch.float32, reference=meta)
    model.train()
    trainable = [(n, p) for n, p in model.named_parameters()
                 if not n.startswith("model.vision_tower.")]
    for n, p in model.named_parameters():
        p.requires_grad_(not n.startswith("model.vision_tower."))
    params = [p for _, p in trainable]
    start = [p.detach().clone() for p in params]
    opt = torch.optim.AdamW(params, lr=0.0, betas=(BETA1, 0.999), eps=1e-8,
                            weight_decay=t["weight_decay"])
    lr_at = schedule(t["learning_rate"], t["num_train_steps"],
                     t["warmup_ratio"])
    group = _Group(ranks, rank) if ranks > 1 else None
    criterion = PSALMCriterion(cfg.loss, cfg.mask_decoder.num_queries,
                               uniform_fn=batches.Draws(seed, device),
                               mesh=group)
    losses, grads, keep = [], {}, {}
    sums = [dict() for _ in judged]
    mine = ({"loss": losses, "grad": {}, "delta": {} if rank == 0 else None}
            if record else None)
    layers.LOWER = lower
    try:
        for i in range(CHECK_STEPS):
            batch = {k: torch.as_tensor(v).to(device) for k, v in
                     pool[i].items() if k not in HOST_KEYS}
            if rows is not None:
                batch = {k: v[:rows] for k, v in batch.items()}
            for p in params:
                p.grad = None
            out = model(batch, train=True, use_class_names=True,
                        num_class_names=mix["class_names"])
            targets = {"masks": batch["gt_masks"],
                       "labels": batch["gt_labels"],
                       "valid": batch["gt_valid"]}
            loss = criterion(None, out, targets, compute_seg=False,
                             compute_class=True,
                             compute_region=False)["loss_total"]
            loss.backward()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if ranks > 1 and exchange:
                    dist.all_reduce(p.grad)
            total = loss.detach().clone()
            if ranks > 1:
                dist.all_reduce(total)
            losses.append(float(total))
            if i == 0:
                with torch.no_grad():
                    for n, p in trainable:
                        grads[n], keep[n] = _first(p.grad)
                        for j, got in zip(sums, judged):
                            j[n] = _gradient_sums(got["grad"][n], p.grad,
                                                  rank, ranks)
                        if record:
                            mine["grad"][n] = (p.grad.to("cpu", copy=True),
                                               None)
            for g in opt.param_groups:
                g["lr"] = lr_at(i)
            opt.step()
    finally:
        layers.LOWER = None
    judged_out = [{"loss": list(got["loss"]), **_reduced(j, ranks)}
                  for got, j in zip(judged, sums)]
    with torch.no_grad():
        change = {}
        for k, ((n, p), s) in enumerate(zip(trainable, start)):
            d = p - s
            change[n] = float(torch.linalg.vector_norm(d[keep[n]]))
            for got, j in zip(judged, judged_out):
                if got["delta"] is not None:
                    dp = got["delta"][n].to(device)
                    j.setdefault("change", {})[n] = float(
                        torch.linalg.vector_norm(dp[keep[n]]))
            if record and rank == 0:
                mine["delta"][n] = d.to("cpu", copy=True)
            start[k] = None
    del model, opt, start, params, trainable, keep
    gc.collect()
    torch.cuda.empty_cache()
    own = {"loss": losses, "grad": grads, "change": change}
    return {"own": own, "judged": judged_out, "record": mine}


def _first(grad: torch.Tensor):
    """(norm, the elements that count in the change) of a reference
    gradient: those at least ``KEEP`` of its root mean square."""
    norm = torch.linalg.vector_norm(grad)
    rms = norm / max(grad.numel(), 1) ** 0.5
    return float(norm), grad.abs() >= KEEP * rms


def _gradient_sums(got, want: torch.Tensor, rank: int, ranks: int):
    """[|g|^2, |g - want|^2] of a program's first gradient ``got`` = (g,
    axis) against the reference's full ``want``, over this rank's slice,
    and whether the slice is a part (summed over the ranks later)."""
    g, axis = got
    if axis is not None:
        size = want.shape[axis] // ranks
        want = want.narrow(axis, rank * size, size)
    g = g.to(want.device)
    return (torch.stack([g.pow(2).sum(), (g - want).pow(2).sum()]),
            axis is not None)


def _reduced(sums, ranks: int) -> Dict[str, Dict[str, float]]:
    """A judged record's gradient norms and differences, each ZeRO slice's
    squares summed over the ranks."""
    names = list(sums)
    sq = torch.stack([sums[n][0] for n in names])
    part = torch.tensor([sums[n][1] for n in names], device=sq.device)
    if ranks > 1 and bool(part.any()):
        summed = sq * part[:, None]
        dist.all_reduce(summed)
        sq = torch.where(part[:, None], summed, sq)
    sq = sq.sqrt().tolist()
    return {"grad": {n: v[0] for n, v in zip(names, sq)},
            "grad_diff": {n: v[1] for n, v in zip(names, sq)}}


def leaf_shares(diff: Dict[str, float], want: Dict[str, float], names
                ) -> Dict[str, float]:
    """Each leaf's ``diff`` over the larger of its reference norm and the
    median leaf's."""
    vals = sorted(want[n] for n in names)
    median = vals[len(vals) // 2] if vals else 0.0
    return {n: diff[n] / max(want[n], median, 1e-30) for n in names}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names
              ) -> Dict[str, float]:
    """Each leaf's |got - want| over the larger of its reference norm and
    the median leaf's."""
    return leaf_shares({n: abs(got[n] - want[n]) for n in names}, want,
                       names)


def moved(want: Dict[str, Any]):
    """The leaves whose reference gradient is at least ``KEEP`` of the
    median leaf's (the others move under Adam by round-off alone)."""
    grads = sorted(want["grad"].values())
    median = grads[len(grads) // 2]
    return [n for n in sorted(want["grad"])
            if want["grad"][n] >= KEEP * median]


def numbers(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """``loss_gap``: the worst step's |loss - reference| / |reference|;
    ``grad_gap``: the gap of the first gradient's norm, by the worst leaf;
    ``grad_diff_median``: the norm of the first gradient's difference from
    the reference's, by the median leaf of those ``moved`` keeps;
    ``change_gap``: the gap of the norm of each leaf's change after three
    steps, over the elements ``KEEP`` keeps, by the worst leaf of those
    ``moved`` keeps. Each leaf's gap is taken against the larger of its
    reference norm and the median leaf's."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got["loss"], want["loss"]))
    kept = moved(want)
    grad = leaf_gaps(got["grad"], want["grad"], sorted(want["grad"]))
    diff = sorted(leaf_shares(got["grad_diff"], want["grad"], kept).values())
    change = leaf_gaps(got["change"], want["change"], kept)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "grad_diff_median": diff[len(diff) // 2],
            "change_gap": max(change.values())}


def compare(program, ref, limits) -> List[Any]:
    """[(name, value, limit)]; the worst leaves on stderr."""
    for key, names in (("grad", sorted(ref["grad"])), ("change", moved(ref))):
        gaps = leaf_gaps(program[key], ref[key], names)
        worst = max(gaps, key=gaps.get)
        print(f"{key}: worst leaf {worst} gap {gaps[worst]!r}: program "
              f"{program[key][worst]!r}, reference {ref[key][worst]!r}",
              file=sys.stderr)
    return [(k, v, float(limits.get(k, 0.0)))
            for k, v in numbers(program, ref).items()]
