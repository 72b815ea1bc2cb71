"""What every cell of the benchmark shares: the manifest and the files it
names, the caches' places, the device's description, the check that no JAX
was loaded, the profiler's reading and the result line.

Nothing here imports the program (``psalm_tpu_torch``); the drivers do.
"""

from __future__ import annotations

import bisect
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "psalm_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def cell(workload: str, manifest_path: Optional[Path] = None
         ) -> Dict[str, Any]:
    """The workload's entry of ``BENCHMARK.json`` with its configuration
    (``config``), traffic mix (``traffic``) and limits (``limits``) read
    from the files the names lead to, and the end-to-end and per-layer
    metrics it reports (``end_to_end``, ``per_layer``)."""
    manifest = load_json(manifest_path or ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])

    def reported(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    return {**entry,
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH_DIR / "traffic"
                                 / f"{entry['traffic']}.json"),
            "limits": (load_json(limits) if (limits := BENCH_DIR / "limits"
                       / f"{workload}.json").exists() else {}),
            "end_to_end": reported(manifest["end_to_end"]),
            "per_layer": reported(manifest["per_layer"]),
            "run_seconds": manifest["run_seconds"]}


def set_cache_dirs() -> None:
    """Kernel and build caches at fixed places inside the checkout, so that
    only a checkout's first run builds (the port's own kernels are built
    by ``ops/_build.py`` into ``build/psalm_tpu_torch/`` of the checkout)."""
    base = ROOT / "build" / "h100_bench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"  # transformers, if anything loads it
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """The forbidden top-level names present in ``sys.modules``, each
    compared whole (``psalm_tpu_torch`` is not ``psalm_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def require_cards(chips: int) -> None:
    """Exits nonzero, printing no result, without ``chips`` CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("h100_bench: no CUDA card (torch.cuda.is_available() "
                         "is False); no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"h100_bench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found; no result")


# ---------------------------------------------------------------------------
# the profiler's trace


def merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end] intervals as disjoint sorted intervals: the
    time the device was busy, however many streams or engines overlapped
    (the arithmetic of the port's ``bench.py::busy_us``)."""
    out: List[List[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


#: the prefix of the harness's spans (``record_function`` names)
SPAN = "h100_bench::"

#: runtime calls that enqueue work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch", "cudaLaunchCooperativeKernel")
#: runtime calls after which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


class Trace:
    """What the readers of per-layer metrics take from one traced window of
    ``torch.profiler``: the device's intervals, the runtime calls, the
    kernels by name and the harness's spans with their device time.

    ``window_s`` is the traced window on the host clock; ``work`` the
    window's counts (images, samples, steps, FLOPs); ``spans`` maps a span
    name to [bound seconds, calls] over the window (``Spans.totals``)."""

    def __init__(self, prof, window_s: float, work: Dict[str, float],
                 spans: Dict[str, List[float]], chips: int = 1):
        from torch.autograd import DeviceType
        self.window_s = window_s
        self.work = work
        self.chips = chips
        self.spans_bound = spans
        events = list(prof.events())
        # ranges opened on the host (the harness's spans, the optimizer's)
        # show on the device too, as annotations over the kernels launched
        # inside them: they are no work of their own
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        self.cpu_events = [e for e in events
                           if e.device_type == DeviceType.CPU]
        host_names = {e.name for e in self.cpu_events}
        spans_dev = [e for e in device if e.name.startswith(SPAN)]
        self.device_events = [e for e in device
                              if e.name not in host_names
                              and not e.name.startswith(SPAN)
                              and not getattr(e, "is_user_annotation", False)]
        self.intervals = merged((e.time_range.start, e.time_range.end)
                                for e in self.device_events)
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6
        self.runtime = {}
        for e in self.cpu_events:
            if e.name in LAUNCH_CALLS or e.name in SYNC_CALLS:
                self.runtime[e.name] = self.runtime.get(e.name, 0) + 1
        self.span_device_s = {}
        for e in spans_dev:
            key = e.name[len(SPAN):]
            self.span_device_s[key] = self.span_device_s.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6

    def launches(self) -> int:
        return sum(n for k, n in self.runtime.items() if k in LAUNCH_CALLS)

    def syncs(self) -> int:
        return sum(n for k, n in self.runtime.items() if k in SYNC_CALLS)

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(e.time_range.end - e.time_range.start
                   for e in self.device_events if match(e.name)) / 1e6

    def roofline(self, span: str) -> Optional[float]:
        """100 x the bound over the device time of the span's calls, or
        None where the window holds none of them."""
        bound, calls = self.spans_bound.get(span, (0.0, 0))
        device = self.span_device_s.get(span, 0.0)
        if calls == 0 or device <= 0:
            return None
        return 100.0 * bound / device

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing when each began (the
        shortest CPU event that covered the gap's start)."""
        by_op: Dict[str, float] = {}
        for e in self.device_events:
            by_op[e.name] = by_op.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        cpu = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in self.cpu_events
                      if e.name not in LAUNCH_CALLS), key=lambda t: t[0])
        starts = [c[0] for c in cpu]
        gaps: Dict[str, float] = {}
        for (_, end), (nxt, _) in zip(self.intervals, self.intervals[1:]):
            length = (nxt - end) / 1e6
            if length <= 0:
                continue
            i = bisect.bisect_right(starts, end)
            label, best = "python between ops", None
            for s, e, name in cpu[max(0, i - 400):i]:
                if s <= end <= e and (best is None or e - s < best):
                    label, best = name, e - s
            gaps[label] = gaps.get(label, 0.0) + length
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def profile_window():
    """A ``torch.profiler`` over CPU and CUDA activities."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


# ---------------------------------------------------------------------------
# spans around the program's op entries, with the bound of each call


class Spans:
    """Wraps the port's op entries, by attribute of the module that calls
    them, in ``record_function("h100_bench::<name>")`` and adds up each
    call's roofline bound from its arguments (``counts/ops.py``). The
    program's files are not edited: the harness replaces the names in the
    calling modules for the run and puts them back in ``remove``."""

    def __init__(self, peaks: Dict[str, float]):
        self.peaks = peaks
        self.totals: Dict[str, List[float]] = {}
        self.recording = False
        self._undo = []

    def replace(self, module, attr: str, value) -> None:
        """``module.attr`` replaced by ``value`` until ``remove``."""
        self._undo.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    def wrap(self, module, attr: str, name: str, bound_fn) -> None:
        import torch
        original = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if not self.recording:
                return original(*args, **kwargs)
            with torch.profiler.record_function(SPAN + name):
                out = original(*args, **kwargs)
            t = self.totals.setdefault(name, [0.0, 0])
            t[0] += bound_fn(self.peaks, *args, **kwargs)
            t[1] += 1
            return out

        self.replace(module, attr, wrapped)

    def remove(self) -> None:
        for module, attr, original in reversed(self._undo):
            setattr(module, attr, original)
        self._undo = []


def read_metrics(names: Iterable[str], trace: Trace) -> Dict[str, float]:
    """Each per-layer metric's reader (``metrics/<name>.py``'s ``read``) on
    the trace; a reader that returns None leaves its metric out."""
    import importlib.util
    out = {}
    for name in names:
        path = BENCH_DIR / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "h100_bench_metric_" + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(trace)
        if value is not None:
            out[name] = float(value)
    return out


# ---------------------------------------------------------------------------
# the result


def emit(result: Dict[str, Any],
         checks: List[Tuple[str, float, float]]) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, and the result line, with the same numbers under ``compared``
    last, as the last line on standard output."""
    for name, value, limit in checks:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in checks}
    print(json.dumps(result), flush=True)
