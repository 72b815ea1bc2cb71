"""Training step: AdamW with a warmup-cosine schedule, on one card
(``Optimizer``) or with its moments sharded over data-parallel ranks
(``ZeroOptimizer``).

Counterpart of ``psalm_tpu/train/train_step.py``. The recipe's defaults (the
reference's scripts/train.sh): lr 6e-5, cosine decay after a linear warmup
over 3% of the steps, weight decay 0, no gradient clipping; bf16 compute
with f32 parameters needs no loss scaling.

What makes it equal to JAX's optax chain step for step:
  * ``warmup_cosine_schedule`` is ``optax.warmup_cosine_decay_schedule(0,
    lr, max(int(total * ratio), 1), total, 0)``, evaluated, as optax does,
    at the count of updates made before this one, so the first update has
    lr 0;
  * ``torch.optim.AdamW`` takes the same update as ``optax.adamw`` (betas
    0.9 and 0.999, eps 1e-8 outside the square root, bias-corrected moments,
    decay multiplied by lr);
  * a trainable parameter that took no part in the loss gets a zero
    gradient, not ``None``: optax updates every leaf's moments and counts
    every step for all of them;
  * ``grad_norm`` is ``optax.global_norm`` over every gradient, taken
    before the optional clip (``optax.clip_by_global_norm``).
The caller leaves the frozen vision tower out of ``params``: JAX updates it
with zero gradients, which changes nothing while the weight decay is 0. So
too a LoRA model's frozen base (``train/lora.py``), and the int8 / int4
weights and scales are buffers: none of them gets a moment or, under a
mesh, a place in a gradient bucket.

``ZeroOptimizer`` is ``Optimizer``'s step over a ``parallel.mesh.Mesh``,
JAX's ZeRO step (``opt_state_sharding``, ``_zero_spec``), with collectives
around it: the gradients are summed over the data group in flat buckets
(each rank's loss is its share of the global loss, ``train/criterion.py``,
so the sum is the one-process gradient of the global batch; a replicated
parameter's is then averaged over the model group, so that its copies stay
equal), the norm is taken, the clip applied, and then each rank updates
only its slice of each parameter, on the axis ``_zero_spec`` picks (the
first one that tensor parallelism leaves free, divisible by and at least
the data size), with Adam's moments for that slice alone; the slices are
all-gathered over the data group back into the parameter. A parameter with
no such axis, and every parameter at data 1, keeps whole moments and is
updated in place. Under tensor parallelism a split parameter's squared norm
is summed over the model group and a replicated one counted once, so
``grad_norm`` is the global norm JAX takes. One process is the 1 x 1 mesh:
both optimizers checkpoint the same layout, which a mesh of any size loads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from psalm_tpu_torch.parallel.mesh import (Mesh, gather_axis, param_spec,
                                           tp_axis)
from psalm_tpu_torch.spans import span

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def warmup_cosine_schedule(lr: float, total_steps: int,
                           warmup_ratio: float) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first)."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = total_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


MOMENTS = ("exp_avg", "exp_avg_sq")


class Optimizer:
    """AdamW, the schedule and the optional global-norm clip over
    ``params``; ``count`` is the number of updates made (optax's count).
    ``names`` key the moments in ``state_dict`` (by default the parameters'
    positions).

    One process is the 1 x 1 case of ``ZeroOptimizer``'s mesh: the same
    step with no collective around it, the same ``state_dict`` layout, and
    a ``load_state_dict`` that takes the states of a mesh of any size."""

    # this rank's place in a ('data', 'model') mesh
    data = model = 1
    data_rank = model_rank = 0

    def __init__(self, params: Iterable[nn.Parameter], lr: float = 6e-5,
                 total_steps: int = 100_000, warmup_ratio: float = 0.03,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None,
                 names: Optional[Iterable[str]] = None):
        self.params: List[nn.Parameter] = list(params)
        self.names = (list(names) if names is not None
                      else [str(i) for i in range(len(self.params))])
        # each parameter's tensor-parallel axis and the axis of the slice
        # that this rank updates (None: the whole parameter)
        self.tp, self.axes = self._layout()
        # what AdamW steps: this rank's slice, or the parameter itself
        self.shards = [p if a is None else
                       self._mine(p.detach(), a).clone().requires_grad_()
                       for p, a in zip(self.params, self.axes)]
        self.schedule = warmup_cosine_schedule(lr, total_steps, warmup_ratio)
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(self.shards, lr=0.0, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)
        self.count = 0

    def _layout(self) -> Tuple[List[Optional[int]], List[Optional[int]]]:
        return [None] * len(self.params), [None] * len(self.params)

    def _mine(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        size = t.shape[axis] // self.data
        return t.narrow(axis, self.data_rank * size, size)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """One update from the parameters' gradients; returns the global
        norm of the gradients before any clip."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        self._reduce(grads)
        norm = self._global_norm(grads)
        if self.grad_clip:
            # optax: g if norm < clip else g / norm * clip
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        for s, p, a in zip(self.shards, self.params, self.axes):
            if a is not None:
                s.grad = self._mine(p.grad, a).contiguous()
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        self._gather()
        return norm

    # the collectives around the update: none on one process

    def _reduce(self, grads: List[torch.Tensor]) -> None:
        pass

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))

    def _gather(self) -> None:
        pass

    @torch.no_grad()
    def refresh(self) -> None:
        """Copies the parameters into the slices that AdamW updates: needed
        after anything but ``step`` wrote the parameters (a checkpoint's
        load)."""
        for s, p, a in zip(self.shards, self.params, self.axes):
            if a is not None:
                s.copy_(self._mine(p, a))

    # -- checkpoints ---------------------------------------------------------

    def state_dict(self) -> dict:
        """This rank's moment slices with what re-slicing them needs: the
        mesh's sizes and this rank's place, and each slice's axis."""
        return {"count": self.count, "data": self.data, "model": self.model,
                "data_rank": self.data_rank, "model_rank": self.model_rank,
                "axes": dict(zip(self.names, self.axes)),
                "tp": dict(zip(self.names, self.tp)),
                "moments": {n: {k: self.adamw.state[s][k] for k in MOMENTS}
                            for n, s in zip(self.names, self.shards)
                            if s in self.adamw.state}}

    def load_state_dict(self, states: List[dict]) -> None:
        """Loads this rank's slices from ``state_dict``s of a mesh of any
        size (one process is 1 x 1): every saved rank's state, or only this
        rank's when the mesh is the same."""
        first = states[0]
        same = (len(states) == 1 and (first["data"], first["model"],
                                      first["data_rank"], first["model_rank"])
                == (self.data, self.model, self.data_rank, self.model_rank))
        if not same:
            by_rank = {(s["data_rank"], s["model_rank"]): s for s in states}
            if len(by_rank) != first["data"] * first["model"]:
                raise ValueError(f"{len(by_rank)} optimizer shards for a "
                                 f"mesh of {first['data']} x {first['model']}")
        state = {}
        for i, (n, a, t) in enumerate(zip(self.names, self.axes, self.tp)):
            if n not in first["moments"]:
                continue
            if same:
                mom = first["moments"][n]
            else:
                mom = {k: self._reslice(by_rank, first, n, k, a, t)
                       for k in MOMENTS}
            state[i] = {"step": torch.tensor(float(first["count"])), **mom}
        self.adamw.load_state_dict({"state": state, "param_groups":
                                    self.adamw.state_dict()["param_groups"]})
        self.count = int(first["count"])

    def _reslice(self, by_rank, first, name, key, axis, tp):
        """This rank's slice of moment ``key`` of ``name``, put together from
        another mesh's slices."""
        saved_axis, saved_tp = first["axes"][name], first["tp"][name]
        parts = []
        for mr in range(first["model"]):
            rows = [by_rank[(dr, mr)]["moments"][name][key].cpu()
                    for dr in range(first["data"])]
            parts.append(rows[0] if saved_axis is None
                         else torch.cat(rows, saved_axis))
        full = parts[0] if saved_tp is None else torch.cat(parts, saved_tp)
        if tp is not None:
            size = full.shape[tp] // self.model
            full = full.narrow(tp, self.model_rank * size, size)
        return full if axis is None else self._mine(full, axis).clone()

    def full_moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every parameter's whole moments (collective under a mesh; for
        checks): copies, which later steps leave as they are."""
        return {n: {k: self._whole(self.adamw.state[s][k], a, t)
                    for k in MOMENTS}
                for n, s, a, t in zip(self.names, self.shards, self.axes,
                                      self.tp)
                if s in self.adamw.state}

    def _whole(self, x: torch.Tensor, axis, tp) -> torch.Tensor:
        return x.clone()


# elements of a gradient all-reduce or a slice all-gather bucket (1 GiB of
# f32 with its gathered copy at data 4)
BUCKET = 1 << 26


def _zero_spec(shape, base: tuple, n: int) -> tuple:
    """``psalm_tpu/train/train_step.py::_zero_spec`` on tuple specs: ``base``
    (a tensor-parallel spec) with 'data' on the first free axis divisible by
    n and at least n; trailing None dropped."""
    parts = list(base) + [None] * (len(shape) - len(base))
    has_data = any(
        p == "data" or (isinstance(p, tuple) and "data" in p) for p in parts)
    for axis, size in enumerate(shape):
        if has_data:
            break
        if parts[axis] is None and size % n == 0 and size >= n:
            parts[axis] = "data"
            break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in flat buckets of one dtype and at most
    BUCKET elements (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        if cur and (size + t.numel() > BUCKET
                    or t.dtype != tensors[cur[0]].dtype):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += t.numel()
    return out + [cur] if cur else out


class ZeroOptimizer(Optimizer):
    """``Optimizer`` over ``mesh``: the gradients reduced, the norm taken
    and the slices all-gathered over its groups, Adam's moments sharded
    over its data group; ``named_params`` are (name, local parameter)
    pairs of a model of ``cfg``, the name and the config deciding the
    tensor-parallel split (``parallel.mesh.param_spec``)."""

    def __init__(self, named_params, mesh: Mesh, cfg, lr: float = 6e-5,
                 total_steps: int = 100_000, warmup_ratio: float = 0.03,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        named = list(named_params)
        self.mesh = mesh
        self.cfg = cfg
        self.data, self.model = mesh.data, mesh.model
        self.data_rank, self.model_rank = mesh.data_rank, mesh.model_rank
        super().__init__([p for _, p in named], lr, total_steps, warmup_ratio,
                         weight_decay, grad_clip, names=[n for n, _ in named])

    def _layout(self):
        tp = [tp_axis(n, self.cfg) if self.model > 1 else None
              for n in self.names]
        axes: List[Optional[int]] = []
        for n, p, t in zip(self.names, self.params, tp):
            if self.data == 1:  # a slice would be a copy of the parameter
                axes.append(None)
                continue
            shape = list(p.shape)
            if t is not None:
                shape[t] *= self.model
            spec = _zero_spec(shape, param_spec(n, self.cfg), self.data)
            axes.append(spec.index("data") if "data" in spec else None)
        return tp, axes

    def _reduce(self, grads: List[torch.Tensor]) -> None:
        """Sums the gradients over the data group in flat buckets. Under
        tensor parallelism a replicated parameter's gradient is then
        averaged over the model group: its model ranks compute it alike,
        but kernels that add by atomics (K2, an embedding's backward) round
        it differently on each, and copies updated apart would drift."""
        m = self.mesh
        split = [i for i, t in enumerate(self.tp) if t is not None]
        whole = [i for i, t in enumerate(self.tp) if t is None]
        for members, across_model in ((split, False), (whole, m.model > 1)):
            if m.data == 1 and not across_model:
                continue  # a sum over one rank
            for bucket in _buckets([grads[i] for i in members]):
                idx = [members[j] for j in bucket]
                flat = torch.cat([grads[i].reshape(-1) for i in idx])
                if m.data > 1:
                    dist.all_reduce(flat, group=m.data_group)
                if across_model:
                    dist.all_reduce(flat, group=m.model_group)
                    flat.div_(m.model)
                for i, chunk in zip(idx, flat.split([grads[i].numel()
                                                     for i in idx])):
                    grads[i].copy_(chunk.view_as(grads[i]))

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        if self.model == 1:
            return super()._global_norm(grads)
        norms = torch.stack(torch._foreach_norm(grads))
        split = torch.tensor([t is not None for t in self.tp],
                             device=norms.device)
        sq = norms.square()
        sharded = torch.where(split, sq, 0.0).sum()
        dist.all_reduce(sharded, group=self.mesh.model_group)
        return torch.sqrt(sharded + torch.where(split, 0.0, sq).sum())

    @torch.no_grad()
    def _gather(self) -> None:
        idx_all = [i for i, a in enumerate(self.axes) if a is not None]
        D = self.data
        for bucket in _buckets([self.shards[i] for i in idx_all]):
            idx = [idx_all[j] for j in bucket]
            flat = torch.cat([self.shards[i].detach().reshape(-1)
                              for i in idx])
            out = torch.empty(D * flat.numel(), dtype=flat.dtype,
                              device=flat.device)
            dist.all_gather_into_tensor(out, flat,
                                        group=self.mesh.data_group)
            out = out.view(D, -1)
            off = 0
            for i in idx:
                s, p = self.shards[i], self.params[i]
                part = out[:, off:off + s.numel()].reshape(D, *s.shape)
                p.copy_(part.movedim(0, self.axes[i]).reshape(p.shape))
                off += s.numel()

    def _whole(self, x, axis, tp):
        m = self.mesh
        if axis is not None:
            x = gather_axis(x, axis, m.data_group, m.data)
        if tp is not None:
            x = gather_axis(x, tp, m.model_group, m.model)
        return x.clone() if axis is None and tp is None else x


def make_optimizer(params: Iterable[nn.Parameter], lr: float = 6e-5,
                   total_steps: int = 100_000, warmup_ratio: float = 0.03,
                   weight_decay: float = 0.0,
                   grad_clip: Optional[float] = None,
                   names: Optional[Iterable[str]] = None) -> Optimizer:
    return Optimizer(params, lr, total_steps, warmup_ratio, weight_decay,
                     grad_clip, names)


@dataclasses.dataclass
class TrainState:
    """What a step advances: the number of updates made, the model and the
    optimizer (the counterpart of JAX's (step, params, opt_state))."""
    step: int
    model: nn.Module
    optimizer: Optimizer


def train_step(state: TrainState, loss_fn: LossFn, batch,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """loss_fn(batch, generator) -> (scalar loss, metrics); one backward and
    one update. Returns the metrics with ``loss`` and ``grad_norm`` (device
    tensors: reading them waits for the step)."""
    state.optimizer.zero_grad()
    loss, metrics = loss_fn(batch, generator)
    with span("train.backward"):
        loss.backward()
    with span("train.optimizer"):
        grad_norm = state.optimizer.step()
    state.step += 1
    return {**{k: v.detach() for k, v in metrics.items()},
            "loss": loss.detach(), "grad_norm": grad_norm}
