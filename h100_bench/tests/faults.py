"""Faults planted underneath the timed path, for the tests that see a run's
``correct`` come out false. Each is a context manager that patches the port
for the length of a run (``plant(name)``), or nothing for ``None``.

* ``answer_altered``: the mask logits of a batch's first image negated
  where the model produces them.
* ``half_batch``: the model (eval) or the step (training) sees the first
  half of the batch's rows; eval returns those rows' outputs twice.
* ``state_unchanged``: AdamW's update skipped, the parameters left as
  they were.
* ``no_exchange``: the gradients not summed over the data ranks.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

EVAL_FAULTS = ("answer_altered", "half_batch")
TRAIN_FAULTS = ("state_unchanged", "half_batch")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def plant(name, kind: str):
    """The patch of fault ``name`` for a driver of ``kind``."""
    import torch
    if name is None:
        return contextlib.nullcontext()
    if kind == "eval":
        from psalm_tpu_torch.models.psalm import PSALM
        forward = PSALM.forward
        if name == "answer_altered":
            def altered(self, batch, **kw):
                out = forward(self, batch, **kw)
                masks = out["pred_masks"].clone()
                masks[0] = -masks[0]
                return {**out, "pred_masks": masks}
            return _patched(PSALM, "forward", altered)
        if name == "half_batch":
            def half(self, batch, **kw):
                n = batch["tok_ids"].shape[0]
                out = forward(self, {k: v[:n // 2] for k, v in batch.items()},
                              **kw)

                def twice(d):
                    return {k: torch.cat([v, v]) if torch.is_tensor(v)
                            and v.dim() and v.shape[0] == n // 2 else v
                            for k, v in d.items()}
                return {**twice(out), "aux_outputs": [
                    twice(a) for a in out.get("aux_outputs", [])]}
            return _patched(PSALM, "forward", half)
    else:
        from psalm_tpu_torch.train import train as train_mod
        from psalm_tpu_torch.train import train_step
        if name == "state_unchanged":
            step = train_step.Optimizer.step

            def frozen(self):
                self.adamw.step, real = (lambda: None), self.adamw.step
                try:
                    return step(self)
                finally:
                    self.adamw.step = real
            return _patched(train_step.Optimizer, "step", frozen)
        if name == "half_batch":
            stage = train_mod.Trainer.stage

            def half(self, batch_np):
                staged = stage(self, batch_np)
                n = staged["tok_ids"].shape[0]
                return {k: v[:n // 2] for k, v in staged.items()}
            return _patched(train_mod.Trainer, "stage", half)
        if name == "no_exchange":
            return _patched(train_step.ZeroOptimizer, "_reduce",
                            lambda self, grads: None)
    raise ValueError(f"no fault {name!r} for {kind}")


def run_rank(workload: str, rank: int, port: int, ranks: int, fault, out):
    """One rank of a tiny data-parallel cell on the CPU (gloo), with
    ``fault`` planted; rank 0 writes its checks to ``out`` as JSON."""
    import json

    import torch

    from h100_bench.drivers import train
    from h100_bench.tests import tiny
    torch.set_num_threads(1)
    ctx = tiny.context(workload, rank=rank, port=port, seconds=0.3)
    ctx.mix["data_ranks"] = ranks
    with plant(fault, "train"):
        result = train.run(ctx)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result["checks"], f)


if __name__ == "__main__":
    w, r, p, n, f, o = sys.argv[1:7]
    run_rank(w, int(r), int(p), int(n), None if f == "none" else f, o)
