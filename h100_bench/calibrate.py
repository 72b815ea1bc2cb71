#!/usr/bin/env python3
"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size:

    python3 h100_bench/calibrate.py --workload NAME --seeds 11,12,13 \
        [--program 11,12] [--traced 11] [--seconds 3] [--dump DIR]

For each of ``--program``'s seeds it makes a whole run of the cell in this
process (the driver's ``run``, a short window, traced for ``--traced``'s
seeds): the program's readings, the lower ones. For each of ``--seeds`` it
puts the control in the program's place: the reference computed with every
linear and convolution in float8 (e4m3, one scale a tensor, f32 products:
``reference/layers.py::LOWER``), the nearest precision below the
configuration's bf16. It checks it exactly as a run checks the program:
eval cells on the calls a run would check, with the same heads; training
cells on the first three steps. For training cells it also reads the faults
planted in the reference put in the program's place: half of each rank's
batch left out (the loss the mean over the rest), and on a cell of several
cards the gradients not summed over them. One JSON line a seed and kind on
standard output, and with ``--dump`` every image's or parameter's reading
in ``DIR/<workload>.<seed>.<kind>.json``; the benchmark's runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

CONTROL = torch.float8_e4m3fn


def eval_readings(ctx, seed: int, details=None):
    """The control's numbers on the calls a run of ``seed`` checks."""
    from h100_bench import weights
    from h100_bench.drivers import eval as ev
    from h100_bench.gen import batches
    mix, config = ctx.mix, ctx.config
    device = ctx.device or torch.device("cuda", 0)
    cfg = weights.reference_config(config)
    pool = [batches.eval_batch(mix, cfg.image_size,
                               cfg.mask_decoder.num_queries, seed, i)
            for i in range(mix["pool_batches"])]
    kept = {}
    for n in ev.check_calls(mix, seed):
        batch = pool[n]
        out = ev.reference_outputs(config, mix, seed, batch, device,
                                   lower=CONTROL)
        heads = ev.reference_heads(config, mix, out, batch)
        if mix["task"] == "panoptic":
            out["sem_scores"] = [h["sem_scores"][:, ::ev.SEM_STRIDE,
                                                 ::ev.SEM_STRIDE]
                                 for h in heads]
        kept[n] = (as_program_result(mix, heads), out)
    detail = {}
    checks = ev.check(config, mix, seed, pool, kept, device, ctx.limits,
                      detail=detail)
    if details is not None:
        details["control"] = detail
    return {"control": {k: v for k, v, _ in checks}}


def as_program_result(mix, heads):
    """The reference heads' per-image results in ``EvalRunner.infer``'s
    layout (stacked segments; referring masks and scores with their query
    ids)."""
    import numpy as np
    if mix["task"] == "panoptic":
        return {"panoptic_seg": [h["panoptic_seg"] for h in heads],
                "sem_seg": [h["sem_seg"] for h in heads],
                "segments": {k: np.stack([h["segments"][k] for h in heads])
                             for k in heads[0]["segments"]}}
    Q = heads[0]["masks"].shape[0]
    return {"referring": {
        "masks": [h["masks"].cpu().numpy() for h in heads],
        "scores": np.stack([h["scores"].cpu().numpy() for h in heads]),
        "query": np.tile(np.arange(Q), (len(heads), 1))}}


def train_readings(ctx, seed: int, device, flags, details=None):
    """The control's and the faults' numbers against the reference: each
    kind's three steps recorded, then judged by one sound reference."""
    from h100_bench.drivers import train as tr
    from h100_bench.gen import batches
    from h100_bench.weights import reference_config
    mix, config = ctx.mix, ctx.config
    ranks = mix["data_ranks"]
    cfg = reference_config(config)
    pool = [batches.train_batch(mix, cfg.image_size,
                                cfg.mask_decoder.num_queries, seed, i,
                                ctx.rank, ranks)
            for i in range(tr.CHECK_STEPS)]
    kinds = {"control": dict(lower=CONTROL),
             "half_batch": dict(rows=mix["batch"] // 2)}
    if ranks > 1:
        kinds["no_exchange"] = dict(exchange=False)
    records = [tr.reference_steps(config, mix, seed, pool, device, ctx.rank,
                                  record=True, **kw)["record"]
               for kw in kinds.values()]
    ref = tr.reference_steps(config, mix, seed, pool, device, ctx.rank,
                             judged=records)
    del records
    out = {}
    for kind, got in zip(kinds, ref["judged"]):
        if ctx.rank == 0:
            out[kind] = tr.numbers(got, ref["own"])
            if details is not None:
                details[kind] = {"got": got, "reference": ref["own"]}
    if flags is not None:
        torch.distributed.barrier(group=flags)
    return out


def program_readings(ctx, seed: int, seconds: float, trace: bool,
                     details=None):
    """A whole run of the cell on ``seed`` in this process: its checks,
    and for a traced one its per-layer metrics."""
    import importlib
    from h100_bench.run import Context
    args = argparse.Namespace(workload=ctx.workload, seed=seed,
                              seconds=seconds, trace=int(trace), rank=0,
                              port=0)
    run_ctx = Context(args, ctx.cell)
    driver = importlib.import_module(f"h100_bench.drivers.{ctx.mix['kind']}")
    out = driver.run(run_ctx)
    if details is not None:
        details["program"] = out.get("detail")
    got = {"checks": {k: [v, limit] for k, v, limit in out["checks"]},
           "correct": all(v <= limit for _, v, limit in out["checks"]),
           "attempted": out["attempted"], "window_s": out["window_s"],
           "check_s": out["check_s"]}
    if trace:
        got["per_layer"] = out["per_layer"]
        got["busy_s"] = out["busy_s"]
    return {"program": got}


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="the control's (and faults')")
    p.add_argument("--program", default="",
                   help="seeds of whole runs in this process (one card)")
    p.add_argument("--traced", default="", help="those of them traced")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dump", default="")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    from h100_bench import common
    from h100_bench.run import Context, stop_peers
    common.set_cache_dirs()
    cell = common.cell(args.workload)
    common.require_cards(cell["chips"])
    ranks = cell["traffic"].get("data_ranks", 1)
    if args.program and ranks > 1:
        raise SystemExit("--program: one-card cells only")
    peers = []
    if args.rank == 0 and ranks > 1:
        from h100_bench.drivers.train import free_port
        args.port = free_port()
        import subprocess
        peers = [subprocess.Popen(
            [sys.executable, __file__, "--workload", args.workload,
             "--seeds", args.seeds, "--rank", str(r), "--port",
             str(args.port)], cwd=str(ROOT)) for r in range(1, ranks)]
    args.seed, args.trace = 0, 0
    ctx = Context(args, cell)
    ctx.cell = cell
    jobs = [(s, "program") for s in seeds(args.program)]
    jobs += [(s, "control") for s in seeds(args.seeds)]
    traced = set(seeds(args.traced))
    device = flags = None
    if cell["traffic"]["kind"] == "train" and args.seeds:
        from h100_bench.drivers.train import init_group
        device, flags = init_group(ctx)

    def read(seed, kind, details):
        if kind == "program":
            return program_readings(ctx, seed, args.seconds, seed in traced,
                                    details)
        if cell["traffic"]["kind"] == "eval":
            return eval_readings(ctx, seed, details)
        return train_readings(ctx, seed, device, flags, details)
    try:
        for seed, kind in jobs:
            t0 = time.perf_counter()
            details = {} if args.dump else None
            readings = read(seed, kind, details)
            if args.rank == 0:
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "seconds": time.perf_counter() - t0,
                                  **readings}), flush=True)
                for k, d in (details or {}).items():
                    path = Path(args.dump) / f"{args.workload}.{seed}.{k}.json"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_text(json.dumps(d))
    finally:
        bad = stop_peers(peers, timeout=600)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
