"""Training step: AdamW with a warmup-cosine schedule.

Counterpart of ``psalm_tpu/train/train_step.py`` on one card (its ZeRO
sharding over a device mesh is not ported). The recipe's defaults (the
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
with zero gradients, which changes nothing while the weight decay is 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

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


class Optimizer:
    """AdamW, the schedule and the optional global-norm clip over
    ``params``; ``count`` is the number of updates made (optax's count)."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float = 6e-5,
                 total_steps: int = 100_000, warmup_ratio: float = 0.03,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        self.params: List[nn.Parameter] = list(params)
        self.schedule = warmup_cosine_schedule(lr, total_steps, warmup_ratio)
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)
        self.count = 0

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
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip:
            # optax: g if norm < clip else g / norm * clip
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(params: Iterable[nn.Parameter], lr: float = 6e-5,
                   total_steps: int = 100_000, warmup_ratio: float = 0.03,
                   weight_decay: float = 0.0,
                   grad_clip: Optional[float] = None) -> Optimizer:
    return Optimizer(params, lr, total_steps, warmup_ratio, weight_decay,
                     grad_clip)


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
    loss.backward()
    grad_norm = state.optimizer.step()
    state.step += 1
    return {**{k: v.detach() for k, v in metrics.items()},
            "loss": loss.detach(), "grad_norm": grad_norm}
