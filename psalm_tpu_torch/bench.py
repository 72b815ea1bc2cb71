"""Benchmark: COCO-panoptic-eval images/sec on one card for the flagship
PSALM model.

    python -m psalm_tpu_torch.bench        # from the root of a checkout

Counterpart of the JAX package's ``bench.py``, with its geometry, modes,
environment variables and JSON line. It runs the real eval path
(``eval/runner.py::EvalRunner``): Swin-B, the projector, Phi-1.5 with
``use_flash`` (kernel K5, causal), the MSDeformAttn pixel decoder (kernel
K1), the 9-layer mask decoder, the crop-then-head geometry and the panoptic
merge, at batch ``PSALM_BENCH_BATCH`` (default 1), bf16 compute with bf16
parameter storage, random weights from a seeded ``torch.Generator``, on
COCO's non-square geometry (content 768x1024 in the padded 1024^2 frame,
original 480x640, bucket 640x640) and 81 class names.

Modes (``PSALM_BENCH_MODES``, default ``window8,window4,deformable``; the
first listed is the headline):
  windowR         the window clamp at a flat radius R (default 8): K1 with
                  one radius for every sampling point;
  windowpp[spec]  a radius per point, ``spec`` comma-separated (default
                  2,4,6,8): K1 with ``window_point_radii``;
  deformable      the exact, unclamped sampler.

Per mode (``measure_mode``), after ``warmup`` images:
  p50             of ``EvalRunner.infer`` (device work, the device-to-host
                  copy and the host crop), over ``iters`` images;
  blocking        img/s of ``_infer_device`` followed by summing its
                  ``panoptic_seg`` on the host, image after image;
  pipelined       img/s with two images in flight: image i+1's
                  ``_infer_device`` is issued before image i's result is
                  read (``bench.py``'s depth-2 loop);
  device          1 / the device's busy time an image: the union of the
                  kernel, copy and fill intervals in ``torch.profiler``'s
                  trace of ``iters`` blocking images, over the image count.
                  Not measured (null) on the CPU.
The headline is wall clock only: ``value`` is max(blocking, pipelined).
``bench.py``'s third rate, an in-program ``lax.scan`` timed on one
dispatch, has no counterpart here until the eval step is captured in a
CUDA graph (ROADMAP.md, Queue 1), so the device rate is reported beside
the headline and never taken as it. ``pipelined_corroborates_headline``
keeps ``bench.py``'s definition: pipelined >= 0.85 x device.

Baseline: ``bench.py::measure_torch_baseline``'s recipe, a
``transformers`` ``PhiModel`` forward at 1350 tokens on the host CPU (a
lower bound of the reference's work an image), cached in
``build/psalm_tpu_torch_bench_baseline.json``.

Prints a line per mode on stderr, with the K1, K3 and K5 launches an image
(6, 24 and 24 on the card), and one JSON line on stdout.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

CONTENT_HW = (768, 1024)   # content region in the padded frame (4:3 resize)
ORIGINAL_HW = (480, 640)   # COCO-typical original size
BUCKET_HW = (640, 640)     # covers every COCO original
GEOMETRY = (CONTENT_HW, ORIGINAL_HW, BUCKET_HW)

BATCH = int(os.environ.get("PSALM_BENCH_BATCH", "1"))
DEFAULT_MODES = "window8,window4,deformable"
BASELINE_PATH = (Path(__file__).resolve().parents[1] / "build"
                 / "psalm_tpu_torch_bench_baseline.json")


def mode_spec(m: str) -> Tuple[str, Any, str]:
    """(attention_mode, radius, key) of one entry of PSALM_BENCH_MODES, with
    ``bench.py``'s parsing and key names (fractional radii: 2.5 -> 2p5)."""
    m = m.strip()
    if m.startswith("windowpp"):
        spec = m[len("windowpp"):] or "2,4,6,8"
        radius = tuple(float(v) for v in spec.split(","))
        key = "window_pp" + "_".join(
            f"{v:g}".replace(".", "p") for v in radius)
        return "window", radius, key
    if m.startswith("window"):
        radius = float(m[len("window"):] or 8)
        return "window", radius, f"window_r{radius:g}".replace(".", "p")
    return "deformable", None, "deformable_parity"


def build(mode: str, radius, cfg=None, device="cuda", batch_size=BATCH,
          geometry=GEOMETRY, seed=0):
    """(EvalRunner, batch) for one mode: ``cfg`` (PSALMConfig() in bf16 by
    default) with the pixel decoder's mode as ``bench.py::_build`` sets it,
    ``PSALM(use_flash=True)`` with random weights from ``seed`` stored in
    the compute type, and a synthetic panoptic batch of ``num_classes + 1``
    names."""
    from psalm_tpu_torch.config import PSALMConfig
    from psalm_tpu_torch.eval.runner import (EvalRunner,
                                             synthetic_panoptic_batch)
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    cfg = cfg or PSALMConfig(compute_dtype="bfloat16")
    pd_kw = dict(attention_mode=mode)
    if mode == "window":
        if isinstance(radius, tuple):
            pd_kw["window_point_radii"] = radius
        else:
            pd_kw["window_radius"] = radius
    cfg = cfg.replace(pixel_decoder=dataclasses.replace(cfg.pixel_decoder,
                                                        **pd_kw))
    K = cfg.num_classes + 1
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = PSALM(cfg, dtype=dtype, device=device, use_flash=True)
    init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    model.to(dtype)
    content, original, bucket = geometry
    batch = synthetic_panoptic_batch(cfg, batch_size, K, content, original)
    runner = EvalRunner(model, cfg, num_class_names=K,
                        is_thing=[i % 2 == 0 for i in range(K - 1)],
                        bucket_hw=bucket, window_clamp_threshold=None)
    return runner, batch


def launch_counts() -> Dict[str, int]:
    """The launch counters of K1, K3 and K5 (both ways): a run's launches
    are the difference of two readings (the counters are left as they
    are)."""
    from psalm_tpu_torch.ops import flash_attention, msdeform, swin_attention
    return {"K1": msdeform.LAUNCHES, "K3": swin_attention.LAUNCHES,
            "K5": flash_attention.LAUNCHES}


def busy_us(events) -> float:
    """The union of the events' [start, end] intervals, in us: time the
    device was busy, however many streams or engines overlapped."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def device_busy_us(run, tries: int = 10) -> float:
    """The device's busy us (``busy_us``) over one traced ``run()``: the
    kernels, copies and fills in ``torch.profiler``'s CUDA trace. A trace
    that holds no device event (the profiler returns some now and then) is
    taken again after a pause, up to ``tries`` times, then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        us = busy_us(events)
        if us > 0:
            return us
    raise RuntimeError("torch.profiler recorded no device events in "
                       f"{tries} traces: no device time")


def measure_mode(mode: str, radius=8.0, iters: int = 8, warmup: int = 2,
                 cfg=None, device="cuda", batch_size=BATCH,
                 geometry=GEOMETRY, runner=None, batch=None
                 ) -> Dict[str, Any]:
    """Blocking, pipelined and device img/s, the p50 of ``infer`` (s) and
    the K1 / K3 / K5 launches an image, for one mode (``bench.py``'s
    ``measure_mode``). ``runner`` and ``batch`` (from ``build``) may be
    given; else they are built here and freed at the end."""
    from psalm_tpu_torch.eval.runner import _content_hw
    if runner is None:
        runner, batch = build(mode, radius, cfg=cfg, device=device,
                              batch_size=batch_size, geometry=geometry)
    on_card = runner.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    B = len(batch["images"])
    content = _content_hw(batch, runner.cfg.image_size)
    original = np.asarray(batch["original_hw"]).reshape(-1, 2)
    staged = runner.stage(batch)

    def infer_device():
        return runner._infer_device(staged, content, original)

    def host_sum(out):
        return int(out["panoptic_seg"].cpu().numpy().sum())

    # latency: the full infer() (device, download, host crop)
    for _ in range(warmup):
        runner.infer(batch)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        runner.infer(batch)
        times.append(time.perf_counter() - t0)
    p50 = sorted(times)[len(times) // 2]

    # blocking: every result read on the host before the next image
    acc = 0
    sync()
    before = launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        acc += host_sum(infer_device())
    blocking = iters * B / (time.perf_counter() - t0)
    launches = {k: (v - before[k]) / (iters * B)
                for k, v in launch_counts().items()}

    # pipelined: image i+1 issued before image i's result is read
    n = iters * 2
    pending = []
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        pending.append(infer_device())
        if len(pending) > 2:
            acc += host_sum(pending.pop(0))
    for out in pending:
        acc += host_sum(out)
    pipelined = n * B / (time.perf_counter() - t0)
    print(f"  [checksum {acc & 0xFFFF}]", file=sys.stderr)

    device_ips = None
    if on_card:
        def run():
            for _ in range(iters):
                host_sum(infer_device())

        device_ips = iters * B / (device_busy_us(run) / 1e6)
    return {"blocking": blocking, "pipelined": pipelined,
            "device": device_ips, "ips": max(blocking, pipelined),
            "p50": p50, "launches": launches}


def measure_torch_baseline(seq_len: int = 1350) -> float:
    """``bench.py``'s torch-CPU reference proxy: a Phi-1.5 full-sequence
    forward (the LLM pass alone, a strict subset of the reference's work an
    image) with ``transformers``, images/sec."""
    from transformers import PhiConfig, PhiModel
    torch.manual_seed(0)
    cfg = PhiConfig(vocab_size=51200, hidden_size=2048, intermediate_size=8192,
                    num_hidden_layers=24, num_attention_heads=32,
                    max_position_embeddings=2048, partial_rotary_factor=0.5)
    model = PhiModel(cfg).eval()
    x = torch.randint(0, 51200, (1, seq_len))
    with torch.no_grad():
        model(input_ids=x)  # warmup
        t0 = time.perf_counter()
        iters = 3
        for _ in range(iters):
            model(input_ids=x)
        dt = time.perf_counter() - t0
    return iters / dt


def cached_baseline(path: Path = BASELINE_PATH) -> float:
    """The baseline's img/s from ``path``, measured and written first if it
    is not there."""
    if path.exists():
        with open(path) as f:
            return json.load(f)["cpu_reference_images_per_sec"]
    baseline = measure_torch_baseline()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"cpu_reference_images_per_sec": baseline,
                   "note": "torch-CPU Phi-1.5 forward proxy (lower bound "
                           "of reference per-image cost)"}, f)
    return baseline


def report(key: str, r: Dict[str, Any]) -> None:
    """One mode's line on stderr, as ``bench.py`` prints it, with the
    launches an image."""
    dev = "not measured" if r["device"] is None else f"{r['device']:.2f}"
    print(f"{key}: {r['ips']:.2f} img/s (blocking {r['blocking']:.2f} / "
          f"pipelined {r['pipelined']:.2f} / device {dev}), p50 "
          f"{r['p50'] * 1e3:.1f} ms; launches an image "
          + ", ".join(f"{k} {v:g}" for k, v in r["launches"].items()),
          file=sys.stderr, flush=True)


def summary(results, baseline: Optional[float], kind: str) -> Dict[str, Any]:
    """The JSON line's dict from ``[(key, measure_mode result)]`` in the
    modes' order (the first is the headline); ``vs_baseline`` is null
    without a ``baseline``."""
    extras = {}
    for key, r in results:
        extras[f"{key}_img_per_s"] = round(r["ips"], 2)
        extras[f"{key}_blocking_img_per_s"] = round(r["blocking"], 2)
        extras[f"{key}_pipelined_img_per_s"] = round(r["pipelined"], 2)
        extras[f"{key}_device_img_per_s"] = (
            None if r["device"] is None else round(r["device"], 2))
        extras[f"{key}_p50_ms"] = round(r["p50"] * 1e3, 1)
        extras[f"{key}_launches_per_image"] = r["launches"]
    first, primary = results[0]
    winner = max(("blocking", "pipelined"), key=lambda k: primary[k])
    corroborated = (None if primary["device"] is None
                    else primary["pipelined"] >= 0.85 * primary["device"])
    return {
        "pipelined_corroborates_headline": corroborated,
        "metric": "images_per_sec_per_chip_coco_panoptic_eval",
        "value": round(primary["ips"], 3),
        "unit": "images/sec",
        "vs_baseline": (None if baseline is None
                        else round(primary["ips"] / baseline, 2)),
        "p50_ms": round(primary["p50"] * 1e3, 1),
        "headline_method": winner,
        "note": f"{first} first listed; headline = max of blocking / "
                "depth-2-pipelined wall-clock rates (the device rate, 1 / "
                "the profiler's busy time an image, rides along and is "
                "never the headline: the port has no counterpart of "
                "bench.py's in-program scan until the eval step runs as a "
                "CUDA graph)",
        "device": kind,
        **extras,
    }


def run(modes=None, cfg=None, device="cuda", iters: int = 8,
        warmup: int = 2, batch_size=BATCH, geometry=GEOMETRY,
        baseline: Optional[float] = None) -> Dict[str, Any]:
    """Measure each mode (``PSALM_BENCH_MODES`` by default), freeing each
    mode's model before the next is built; print a line per mode on stderr
    and return the JSON line's dict. ``baseline``: the CPU reference's
    img/s (``cached_baseline()`` when None)."""
    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("psalm_tpu_torch.bench needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    if modes is None:
        modes = os.environ.get("PSALM_BENCH_MODES", DEFAULT_MODES).split(",")
    if baseline is None:
        baseline = cached_baseline()
    results = []
    for m in modes:
        mode, radius, key = mode_spec(m)
        r = measure_mode(mode, radius, iters=iters, warmup=warmup, cfg=cfg,
                         device=device, batch_size=batch_size,
                         geometry=geometry)
        gc.collect()  # the mode's model, before the next one is built
        if on_card:
            torch.cuda.empty_cache()
        report(key, r)
        results.append((key, r))
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    return summary(results, baseline, kind)


def main(**kw):
    """``run(**kw)``'s JSON line on stdout."""
    print(json.dumps(run(**kw)), flush=True)


if __name__ == "__main__":
    main()
