#!/usr/bin/env python3
"""The benchmark of ``psalm_tpu_torch`` on NVIDIA H100 cards: one cell, once.

    python3 h100_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``), whose ``kind`` picks the driver
(``drivers/<kind>.py``): the driver loads and warms the program, measures
for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or traces a
short window (``--trace 1``: its per-layer metrics, each read by
``metrics/<name>.py``), then checks what the timed calls produced against
the plain reference (``reference/``) with the limits of
``limits/<workload>.json``. The run prints each compared number beside its
limit as the last lines on standard error, and one JSON line, the result,
as the last line on standard output. It exits nonzero without a result
where there is no card, too few cards, or JAX loaded in this process.

A cell of several cards runs one process a card: this one is rank 0 and
prints the result; it starts the others (``--rank``) and waits for them.
"""

from __future__ import annotations

import argparse
import importlib
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0,
                   help="a cell's further card (started by rank 0)")
    p.add_argument("--port", type=int, default=0,
                   help="rank 0's rendezvous port (given to the others)")
    return p.parse_args(argv)


class Context:
    """What a driver is given: the cell, the run's arguments, and the
    clocks and device readings the result needs."""

    def __init__(self, args, cell, device=None):
        import torch
        self.workload = args.workload
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.rank = args.rank
        self.port = args.port
        self.chips = cell["chips"]
        self.config = cell["config"]
        self.mix = cell["traffic"]
        self.limits = cell["limits"]
        self.per_layer_names = [m["name"] for m in cell["per_layer"]]
        self.counts = _counts(args.workload)
        self.device = device
        self.setup_s = None
        self.window_usage = ""
        self._torch = torch

    def sync(self) -> None:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()

    def mark_setup_done(self) -> None:
        """The set-up ends here: process start to the first timed call."""
        self.sync()
        self.setup_s = process_age_s()
        self._usage = resource.getrusage(resource.RUSAGE_SELF)

    def window_closed(self) -> None:
        """What the process took of the host over the window: CPU seconds
        and context switches (printed beside the result, for the spread
        between runs)."""
        now = resource.getrusage(resource.RUSAGE_SELF)
        was = self._usage
        cpu = now.ru_utime - was.ru_utime + now.ru_stime - was.ru_stime
        self.window_usage = (
            f"window CPU {cpu:.2f} s, {now.ru_nivcsw - was.ru_nivcsw} "
            f"involuntary and {now.ru_nvcsw - was.ru_nvcsw} voluntary "
            f"switches, {len(os.sched_getaffinity(0))} cores")

    def memory_peak(self) -> int:
        if not self._torch.cuda.is_available():
            return 0
        return int(self._torch.cuda.max_memory_allocated())


def _counts(workload: str):
    from h100_bench.common import BENCH_DIR, load_json
    path = BENCH_DIR / "counts" / f"{workload}.json"
    return load_json(path) if path.exists() else None


def start_peers(args, chips: int):
    """The other ranks of a cell of ``chips`` cards, each this command with
    ``--rank``, on rank 0's port."""
    procs = []
    for rank in range(1, chips):
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(rank), "--port", str(args.port)]
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT)))
    return procs


def stop_peers(procs, timeout: float = 120.0) -> int:
    """Waits for every peer; kills those still running after ``timeout``.
    Returns the number that did not exit 0."""
    bad = 0
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        bad += p.returncode != 0
    return bad


def main(argv=None) -> int:
    args = parse(argv)
    from h100_bench import common
    common.set_cache_dirs()
    cell = common.cell(args.workload)
    common.require_cards(cell["chips"])
    if args.rank == 0 and cell["chips"] > 1 and not args.port:
        from h100_bench.drivers.train import free_port
        args.port = free_port()
    ctx = Context(args, cell)
    driver = importlib.import_module(f"h100_bench.drivers.{ctx.mix['kind']}")
    peers = start_peers(args, ctx.chips) if args.rank == 0 else []
    try:
        out = driver.run(ctx)
    finally:
        bad_peers = stop_peers(peers)
    if args.rank:
        return 0
    found = common.forbidden_modules()
    if found:
        print(f"h100_bench: {', '.join(found)} loaded in the process that "
              "reports; no result", file=sys.stderr)
        return 3
    if bad_peers:
        print(f"h100_bench: {bad_peers} of the cell's other processes "
              "failed; no result", file=sys.stderr)
        return 4
    import torch
    print(f"card: {common.power_limit()}; set-up {ctx.setup_s:.3f} s, window "
          f"{out['window_s']:.3f} s, check {out['check_s']:.3f} s, process "
          f"{process_age_s():.3f} s; {ctx.window_usage}", file=sys.stderr)
    silent = [n for n in ctx.per_layer_names
              if ctx.trace and n not in out["per_layer"]]
    if silent:
        print(f"h100_bench: {', '.join(silent)} read nothing in a cell that "
              "declares them (a wrapped entry no longer called?); no result",
              file=sys.stderr)
        return 5
    checks = out["checks"]
    correct = all(v <= limit for _, v, limit in checks)
    units = {m["name"]: m["unit"]
             for m in cell["end_to_end"] + cell["per_layer"]}
    if ctx.trace:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["per_layer"].items()}
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["end_to_end"].items()}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": units["setup_s"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": ctx.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
        result["breakdown"] = out["breakdown"]
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
