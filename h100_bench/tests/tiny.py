"""A cell of the benchmark at the port's tiny test config on the CPU: the
drivers' whole run but the look for a card, in f32, at sizes a test holds.
"""

from __future__ import annotations

import copy
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import common  # noqa: E402

#: the mixes' sizes at the tiny config (64^2 frames, 10 queries)
TINY_MIX = {"batch": 2, "pool_batches": 4, "class_names": 6, "things": 3,
            "content_hw": [48, 64], "original_hw": [30, 40],
            "bucket_hw": [64, 64], "warmup_calls": 1, "trace_calls": 2,
            "check_calls": 2, "check_block": 1, "refer_tokens": 4,
            "mask_slots": 4, "valid_masks": 3, "trace_steps": 2}


def tiny_model() -> dict:
    import dataclasses
    from h100_bench.reference.config import tiny_test_config
    cfg = tiny_test_config()
    cfg = cfg.replace(phi=dataclasses.replace(cfg.phi, num_heads=2))
    d = dataclasses.asdict(cfg)
    d["seg_task"] = cfg.seg_task.value
    return json.loads(json.dumps(d))


#: the cells left out of ``BENCHMARK.json`` until their checks are read on
#: the card (``PERF.md``), in the manifest's form: their drivers' paths stay
#: tested here
SHELVED = Path(__file__).resolve().parent / "shelved.json"


def manifest_cell(workload: str) -> dict:
    """``common.cell`` of the workload, from ``BENCHMARK.json`` or, for a
    shelved cell, from ``SHELVED``."""
    with open(SHELVED) as f:
        shelved = {w["name"] for w in json.load(f)["workloads"]}
    return common.cell(workload, SHELVED if workload in shelved else None)


def tiny_cell(workload: str) -> dict:
    """The workload's cell with the tiny model in f32 and the mix cut to
    ``TINY_MIX``'s sizes (the data ranks as the cell has them)."""
    cell = manifest_cell(workload)
    cell = copy.deepcopy(cell)
    cell["config"]["model"] = tiny_model()
    cell["config"]["params_dtype"] = "float32"
    cell["config"]["compute_dtype"] = "float32"
    cell["config"]["model"]["compute_dtype"] = "float32"
    mix = cell["traffic"]
    for k, v in TINY_MIX.items():
        if k in mix:
            mix[k] = v
    return cell


def context(workload: str, seed: int = 7, trace: bool = False,
            seconds: float = 0.5, device="cpu", rank: int = 0, port: int = 0):
    """A driver's context for the tiny cell on ``device``."""
    import torch
    cell = tiny_cell(workload)
    ctx = types.SimpleNamespace(
        workload=workload, seed=seed, seconds=seconds, trace=trace,
        rank=rank, port=port, chips=cell["chips"], config=cell["config"],
        mix=cell["traffic"], limits=cell["limits"],
        per_layer_names=[m["name"] for m in cell["per_layer"]],
        counts={"flops": 1.0}, device=torch.device(device), setup_s=None)
    ctx.sync = lambda: None
    ctx.memory_peak = lambda: 0
    ctx.mark_setup_done = lambda: setattr(ctx, "setup_s", 0.0)
    ctx.window_closed = lambda: None
    return ctx
