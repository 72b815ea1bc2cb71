#!/usr/bin/env python3
"""Smoke run of psalm_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, each of which must pass:
  1. device  - the card's name and power limit (nvidia-smi).
  2. build   - the CUDA kernels of psalm_tpu_torch/csrc, compiled by nvcc for
               sm_90a (one nvcc per source, all at once) into
               build/psalm_tpu_torch/.
  3. kernels - each kernel against its plain PyTorch version on the card, at
               the shapes its path gives it, with the kernel's, the plain
               version's and, where one exists, a single PyTorch call's time
               (CUDA events, medians), and the card's bound for the same work:
                 K1 deformable sampler: B=1, S=Q=21504 (32^2+64^2+128^2),
                    M=8, D=32, L=3, P=4; bf16 and f32; exact and radius=8,
                    with offsets beyond the radius and off the image border;
                    every element within 2^-7 (bf16: one step, both round
                    once) or 1e-5 (f32) of its size + 1e-5 of M, the twin
                    on |value| and |attn| (the sum of absolute terms);
                 K3 Swin window attention: each Swin-B stage of a 1024^2
                    image (window 12, N=144, head dim 32), with and without
                    the shift mask; bf16 (tensor cores) and f32; every
                    element within 2^-7 |want| + 2^-8 P|v| + 1e-5 (bf16:
                    one step, and P rounded to bf16 as the twin rounds it)
                    or 1e-5 |want| + 1e-5 P|v| (f32);
                 K4 int4 matvec: Phi-1.5's decode linears, (K, N) = (2048,
                    2048) q/k/v/dense, (2048, 8192) fc1, (8192, 2048) fc2,
                    group 64, B = 1, 4, 16, x in bf16 and f32; within 1e-5
                    of the output's size on random rows, exact on one-hot
                    rows with power-of-two scales, and one kernel a call in
                    the profiler's trace;
                 K5 attention: causal at Phi's eval shape (B=1, 32 heads of
                    64, L=640) and at L=577, bf16 and f32; non-causal over
                    the S=21504 encoder tokens with 8 heads of 32 and 2 of
                    128, bf16; every element within 2^-7 of its size (one
                    bf16 step) + 2^-8 of P|v| (the bf16 kernel rounds P
                    before P v, as the stock kernel does) + 1e-5 in bf16,
                    1e-5 of its size + 1e-5 in f32;
                 K2 sampler backward: K1's shapes, bf16 and f32, exact and
                    radius=8, offsets off whole pixels; against autograd
                    through the plain sampler; every element of d value,
                    d loc and d attn within rtol of its size + c M, M the
                    sum of its terms' absolute values and c from their
                    number n, max(1e-5, 2 (n + 2) 2^-24) (rtol 2^-7 for
                    bf16 d value and d attn, which are rounded once to
                    bf16; 1e-5 else);
                 K5 backward: causal at L=640 (32 x 64), non-causal at
                    S=21504 with 2 x 128 (the dense training shape) and 8 x
                    32, bf16; against the plain chunked backward on the
                    same out and log-sum-exp; every element within 2^-7 of
                    its size + 2^-8 of the rounded product's magnitude
                    (P^T|dO| for dv, |dS|^T|q| scale for dk, |dS||k| scale
                    for dq) + 1e-5 of the largest; library:
                    scaled_dot_product_attention's backward;
                 and, from the built library's SASS (cuobjdump), that the
                    bf16 K5 forward, dK/dV and dQ kernels and the bf16 K3
                    kernel hold tensor-core instructions, that K1 reads
                    value by 16-byte loads and K2 reduces d value by
                    vector reductions alone wherever they take channel
                    vectors, and that the model's K1 and K2 do not spill,
                    with each K1-K5 kernel's registers, spills and shared
                    memory.
  4. small   - the whole eval slice at the tiny config in f32: kernels on the
               card against the plain versions on the CPU, same weights; the
               panoptic task, then with Phi's use_flash (heads of 32) the
               semantic, instance, referring and region tasks and the
               panoptic task with the dense pixel decoder (one head of 32).
  5. eval    - the COCO-panoptic eval path (EvalRunner.infer) at the full
               published width (PSALMConfig(): Swin-B, Phi-1.5, 6 encoder and
               9 decoder layers) in bf16, with random weights drawn on the card
               from a seeded torch.Generator, on bench.py's geometry (content
               768x1024 in the 1024^2 frame, original 480x640, bucket 640x640,
               81 class names of 3 tokens, sequence padded to 640). The launch
               counters are zeroed just before the timed runs and must show
               every kernel on the path (6 K1 and 24 K3 launches per image);
               then one traced image gives K1's device ms per launch at
               the model's own offsets.
  6. serve   - the chat-serving path at the full published width: Phi-1.5
               quantized to int4 on the card (storage "pallas", compute and KV
               cache in bf16), served by ModelWorker.generate_stream to 4
               concurrent image-less chat requests (the worker's zero canvas
               still runs Swin and the projector) through BatchedGenerator
               (max_batch 4, decode_chunk 32), 64 new tokens each, and one
               Generator.generate call on a random 1024^2 image. The counters
               are zeroed just before and must show 144 K4 launches per decode
               step (24 layers x 6 linears) and 24 K3 per prefill. Then the
               decode step with K4 is held against the packed plain path, and
               prefill and decode are timed at B=1 and B=4 for int4, int8 and
               the unquantized bf16 model.
  7. tasks   - the semantic, instance, referring and region eval tasks
               (EvalRunner.infer) at the full published width in bf16 with
               Phi's use_flash, as bench.py builds the eval model, on
               bench.py's geometry: class names as in phase 5; a referring
               sentence of 12 tokens; 4 regions of 256 points. 2 warm-up and
               3 timed images per task; the counters, zeroed before each
               timed run, must show 24 K5 (causal), 24 K3 and 6 K1 launches
               per image.
  8. dense   - the panoptic task with attention_mode="dense" and use_flash:
               6 non-causal and 24 causal K5 launches per image, no K1.
  9. train (small) - Trainer.step at the tiny config in f32, 2 steps on the
               card against the same steps on the CPU (same weights, the
               same point draws): the deformable pixel decoder (K1, K2),
               and the dense one with Phi's use_flash (K5 and its backward,
               causal and not); losses and grad norm within 1e-3 relative.
 10. train   - Trainer.step at the full published width in the default
               deformable mode: bf16 compute, f32 parameters, AdamW,
               gradient checkpointing, batch 1, a panoptic sample of the
               synthetic dataset (81 class names of 3 tokens, sequence
               640, 16 ground-truth masks at 1024^2, 12544 points); 1
               warm-up and 3 timed steps. Per step: 12 K1 (6 and their 6
               recomputations), 6 K2 and 24 K3 launches. The first update
               (lr 0) leaves the parameters as they were, the second moves
               them, and the frozen tower never moves. One more, traced,
               step gives K1's and K2's device ms per launch.
 11. train dense - the same with attention_mode="dense" (2 heads of 128):
               12 non-causal K5 forwards and 6 backwards per step, no K1 or
               K2.

Each path zeroes the launch counters just before its timed run and reads
them just after. f32 comparisons run with TF32 off. On the line before the
last: a JSON object
with each kernel's checks, launches, times and bound. The last line is
{"ok": true, "device": ...}. Any failure exits nonzero before that line. The
script imports nothing of JAX and nothing of psalm_tpu (it checks both).
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's geometry
CONTENT_HW = (768, 1024)
ORIGINAL_HW = (480, 640)
BUCKET_HW = (640, 640)
TIMED_IMAGES = 5

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the serving slice
CHAT_THREADS = 4
NEW_TOKENS = 64
DECODE_CHUNK = 32
TIMED_STEPS = 32
K4_TOL = 5e-2  # decode-step logits, K4 vs packed plain path, x max |logit|
K4_TRACED_CALLS = 10  # calls in the trace that must show one kernel each

# msdeform.ms_deform_attn_bwd_limit by whether the output is rounded to
# bf16 (d value and d attn in bf16); M = the sum of absolute terms
K2_LIMITS = {True: "2^-7 |want| + c M, c = max(1e-5, 2 (n + 2) 2^-24)",
             False: "1e-5 |want| + c M, c = max(1e-5, 2 (n + 2) 2^-24)"}
# swin_attention.window_attention_limit, M = P|v| from the twin's P
K3_LIMITS = {"bfloat16": "2^-7 |want| + 2^-8 M + 1e-5, M = P|v|",
             "float32": "1e-5 |want| + 1e-5 M, M = P|v|"}
K4_SHAPES = ((2048, 2048, "q/k/v/dense"), (2048, 8192, "fc1"),
             (8192, 2048, "fc2"))
# the eval tasks' slice
TASK_WARMUP, TASK_IMAGES = 2, 3
REFER_TOKENS, REGIONS, REGION_POINTS = 12, 4, 256
SOURCES = {
    "K1": ("psalm_tpu_torch/csrc/msdeform.cu",
           # also replaces msdeform_window_pallas2.py:115, the same function,
           # which no model path of psalm_tpu calls
           "psalm_tpu/ops/msdeform_window_pallas3.py:149"),
    "K3": ("psalm_tpu_torch/csrc/swin_attention.cu",
           "psalm_tpu/ops/swin_attention_pallas.py:82"),
    "K4": ("psalm_tpu_torch/csrc/int4_matvec.cu",
           "psalm_tpu/ops/int4_matvec.py:86"),
    # both call the stock TPU kernel jax.experimental.pallas.ops.tpu
    # .flash_attention, which reaches pl.pallas_call
    "K5 causal": ("psalm_tpu_torch/csrc/flash_attention.cu",
                  "psalm_tpu/models/phi.py:122"),
    "K5 non-causal": ("psalm_tpu_torch/csrc/flash_attention.cu",
                      "psalm_tpu/models/pixel_decoder.py:166"),
    # the gradient of the window sampler (no Pallas kernel: JAX's manual
    # VJP, which msdeform_window_pallas2.py:256 takes as its op's backward)
    "K2": ("psalm_tpu_torch/csrc/msdeform_bwd.cu",
           "psalm_tpu/ops/msdeform_window.py:219"),
    # the stock kernel's backward: _flash_attention_bwd_dkv (:941) and
    # _flash_attention_bwd_dq (:1287), two pl.pallas_calls
    "K5 backward causal": (
        "psalm_tpu_torch/csrc/flash_attention_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "K5 backward non-causal": (
        "psalm_tpu_torch/csrc/flash_attention_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
}


def launch_counts():
    """Every kernel's launches since the counters were last zeroed."""
    from psalm_tpu_torch.ops import (flash_attention, int4_matvec, msdeform,
                                     swin_attention)
    fa = flash_attention
    return {"K1": msdeform.LAUNCHES, "K2": msdeform.BWD_LAUNCHES,
            "K3": swin_attention.LAUNCHES, "K4": int4_matvec.LAUNCHES,
            "K5 causal": fa.CAUSAL_LAUNCHES,
            "K5 non-causal": fa.LAUNCHES - fa.CAUSAL_LAUNCHES,
            "K5 backward causal": fa.BWD_CAUSAL_LAUNCHES,
            "K5 backward non-causal": fa.BWD_LAUNCHES - fa.BWD_CAUSAL_LAUNCHES}


def expected(**per_kernel):
    """A launch count for every kernel: the given ones, 0 for the rest."""
    names = {k.replace(" ", "_").replace("-", "_"): k for k in SOURCES}
    counts = dict.fromkeys(SOURCES, 0)
    counts.update({names[k]: v for k, v in per_kernel.items()})
    return counts


def zero_counts():
    from psalm_tpu_torch.ops import (flash_attention, int4_matvec, msdeform,
                                     swin_attention)
    msdeform.LAUNCHES = msdeform.BWD_LAUNCHES = 0
    swin_attention.LAUNCHES = int4_matvec.LAUNCHES = 0
    flash_attention.LAUNCHES = flash_attention.CAUSAL_LAUNCHES = 0
    flash_attention.BWD_LAUNCHES = flash_attention.BWD_CAUSAL_LAUNCHES = 0


def log(msg):
    print(msg, flush=True)


def fail(msg, code=1):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_time_ms(fn, iters=20, warmup=3):
    """Median over ``iters`` calls of fn, timed with CUDA events around each
    call: device time plus whatever host time the call leaves the device
    idle (a call of a few microseconds of device work is host-bound)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def device_trace(run, what, tries=10):
    """(device events, host us) of ``run()``: the kernels and copies in
    torch.profiler's CUDA trace, and the host clock around it. The profiler
    now and then returns traces without device events, several in a row
    (two of three tries on an H100); such a run is repeated after a pause,
    up to ``tries`` runs, then the phase fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if sum(e.time_range.elapsed_us() for e in events) > 0:
            return events, wall_us
        log(f"  (torch.profiler recorded no device events for {what}, run "
            f"{attempt + 1} of {tries})")
    fail(f"torch.profiler recorded no device events for {what}: no device "
         "time")


def profiled_us(run, what, tries=10):
    """(device us, host us) of ``run()``: the summed duration of the kernels
    and copies in its trace (``device_trace``), and the host clock around
    it."""
    events, wall_us = device_trace(run, what, tries)
    return sum(e.time_range.elapsed_us() for e in events), wall_us


def sampler_ms(run, path, path_ms):
    """K1's and K2's device ms per launch in one traced ``run()`` of a path,
    at the model's own offsets (K2 with its finish kernel, without the
    accumulator's zero fill): logged and kept in ``path_ms[path]``."""
    events, _ = device_trace(run, path)
    found = {}
    for kernel, main, parts in (("K1", "msdeform_fwd_kernel", "msdeform_fwd"),
                                ("K2", "msdeform_bwd_kernel", "msdeform_bwd")):
        launches = sum(main in e.name for e in events)
        if launches:
            us = sum(e.time_range.elapsed_us() for e in events
                     if parts in e.name)
            found[kernel] = us / launches / 1e3
            log(f"  {kernel} in {path}'s trace: {launches} launches, "
                f"{found[kernel]:.4f} ms per launch (phase 3 times it on "
                f"synthetic +-12 px offsets)")
    path_ms[path] = found


def device_ms(fn, iters=20, warmup=3):
    """Device time per call of fn from torch.profiler's CUDA trace over
    ``iters`` calls (``profiled_us``)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    return profiled_us(run, "a kernel check")[0] / iters / 1e3


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` once and do ``flops`` at the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def record(records, kernel, name, err, tol, fn, plain_fn, library_fn, bnd):
    """Time the kernel's call ``fn``, its plain version and the library
    call (device time), log and keep the check."""
    if not err <= tol:
        fail(f"{name}: max abs err {err} > {tol} ({err / tol:.4g}x)")
    ms = device_ms(fn)
    call_ms = cuda_time_ms(fn)
    plain_ms = device_ms(plain_fn, iters=10)
    library_ms = device_ms(library_fn) if library_fn is not None else None
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), kernel {ms:.4f} ms "
        f"(call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})")
    records.append({"kernel": kernel, "name": name, "max_abs_err": err,
                    "tol": tol, "ms": ms, "call_ms": call_ms,
                    "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                    "library_ms": library_ms})


def hold(name, got, want, limit, formula):
    """Every element of ``got`` within ``limit`` of ``want``; logs the worst
    element's share of its limit and fails above 1. Returns (max |got -
    want|, max limit, worst share) for ``record``."""
    diff = (got.float() - want.float()).abs()
    # an element whose limit is 0 (no term reaches it) must be exact
    worst = (diff / limit).masked_fill(diff == 0, 0.0).max().item()
    log(f"  {name}: |out| max {want.float().abs().max().item():.4e}; largest "
        f"|got - want| is {worst:.4f} of its limit {formula}")
    if not worst <= 1.0:
        fail(f"{name}: |got - want| exceeds {formula} by {worst}x")
    return diff.max().item(), limit.max().item(), worst


def deform_inputs(torch, seed, off_whole_pixels=False):
    """Phase 3's sampler inputs on the card, at the 1024^2 encoder's shapes
    (B=1, S=Q=21504 over res5, res4, res3; M=8, D=32, L=3, P=4): offsets to
    +-12 target-level px from each query's reference point, beyond radius 8
    and off the border (with ``off_whole_pixels``, moved 0.05 px off whole
    pixels, where AD of floor takes a side, and off +-8, the clip); value
    and attn in f32. Returns (shapes, loc, value32, attn32, generator)."""
    shapes = ((32, 32), (64, 64), (128, 128))
    B, M, D, L, P = 1, 8, 32, 3, 4
    S = sum(h * w for h, w in shapes)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    from psalm_tpu_torch.models.pixel_decoder import reference_points
    ref = torch.from_numpy(reference_points(shapes)).to(dev)  # [S, L, 2]
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=dev)
    off = (torch.rand(B, S, M, L, P, 2, generator=g, device=dev) * 2 - 1) * 12
    if off_whole_pixels:
        frac = torch.remainder(off, 1.0)
        off = torch.where(frac < 0.05, off + 0.05,
                          torch.where(frac > 0.95, off - 0.05, off))
        off = torch.where((off.abs() - 8).abs() < 0.05, off * 0.98, off)
    loc = (ref[None, :, None, :, None, :]
           + off / norm[None, None, None, :, None, :]).contiguous()
    value32 = torch.randn(B, S, M, D, generator=g, device=dev)
    attn32 = torch.softmax(torch.randn(B, S, M, L * P, generator=g, device=dev),
                           -1).reshape(B, S, M, L, P)
    return shapes, loc, value32, attn32, g


def check_k1(torch, msdeform, records):
    shapes, loc, value32, attn32, _ = deform_inputs(torch, 1)
    B, S, M, D = value32.shape
    L, P = loc.shape[3], loc.shape[4]
    starts = msdeform.level_starts(shapes)
    for dtype in (torch.bfloat16, torch.float32):
        value = value32.to(dtype).contiguous()
        attn = attn32.to(dtype).contiguous()
        elt = value.element_size()
        # value, loc (f32), attn and the output once; per sample 4 corner
        # taps of D channels (multiply-add) and the attention weight
        nbytes = value.numel() * elt + loc.numel() * 4 + attn.numel() * elt \
            + B * S * M * D * elt
        flops = B * S * M * L * P * 10 * D
        for radius in (None, 8.0):
            args = (value, shapes, starts, loc, attn)
            got = msdeform.ms_deform_attn(*args, radius=radius)
            want = msdeform.ms_deform_attn_ref(*args, radius=radius)
            mag = msdeform.ms_deform_attn_magnitude(*args, radius=radius)
            torch.cuda.synchronize()
            name = f"K1 ms_deform_attn {dtype_name(dtype)} radius={radius}"
            formula = ("2^-7" if dtype == torch.bfloat16 else "1e-5") \
                + " |want| + 1e-5 M, M = the twin on |value|, |attn|"
            limit = msdeform.ms_deform_attn_limit(want, mag, dtype)
            err, tol, worst = hold(name, got, want, limit, formula)
            # no single PyTorch call computes the multi-level deformable sum
            record(records, "K1", name, err, tol,
                   lambda: msdeform.ms_deform_attn(*args, radius=radius),
                   lambda: msdeform.ms_deform_attn_ref(*args, radius=radius),
                   None, bound(nbytes, flops, dtype_name(dtype)))
            records[-1].update(limit=formula, worst_of_limit=worst)


def check_k3(torch, swin_attention, records):
    """K3 at each Swin-B stage of a 1024^2 image, every element within
    ``window_attention_limit`` of the twin, whose bf16 P v then sums in f32
    and rounds once."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _check_k3(torch, swin_attention, records)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _check_k3(torch, swin_attention, records):
    import torch.nn.functional as F
    from psalm_tpu_torch.models.swin import shift_attn_mask
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    ws, N = 12, 144
    for stage, (res, C, h) in enumerate(((256, 128, 4), (128, 256, 8),
                                         (64, 512, 16), (32, 1024, 32))):
        Hp = -(-res // ws) * ws
        nW = (Hp // ws) ** 2
        hd = C // h
        qkv32 = torch.randn(nW, N, 3 * C, generator=g, device=dev)
        bias = torch.randn(h, N, N, generator=g, device=dev)
        mask = torch.from_numpy(shift_attn_mask(Hp, Hp, ws, ws // 2)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dtype).contiguous()
            q, k, v = (t.reshape(nW, N, h, hd).transpose(1, 2).contiguous()
                       for t in qkv.split(C, dim=-1))
            for m in (None, mask):
                args = (qkv, bias, m, h, hd ** -0.5)
                got = swin_attention.window_attention(*args)
                want = swin_attention.window_attention_ref(*args)
                mag = swin_attention.window_attention_magnitude(*args)
                torch.cuda.synchronize()
                name = (f"K3 window_attention {dtype_name(dtype)} "
                        f"stage{stage} Bn={nW} C={C} h={h} "
                        f"{'shift-mask' if m is not None else 'no-mask'}")
                formula = K3_LIMITS[dtype_name(dtype)]
                limit = swin_attention.window_attention_limit(want, mag, dtype)
                err, tol, worst = hold(name, got, want, limit, formula)
                del mag, limit
                am = (bias[None] if m is None else bias[None] + m[:, None])
                am = am.to(dtype).contiguous()
                elt = qkv.element_size()
                nbytes = qkv.numel() * elt + bias.numel() * 4 \
                    + (m.numel() * 4 if m is not None else 0) \
                    + nW * N * C * elt
                flops = 4 * nW * h * N * N * hd  # q k^T and p v
                record(records, "K3", name, err, tol,
                       lambda: swin_attention.window_attention(*args),
                       lambda: swin_attention.window_attention_ref(*args),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=am, scale=hd ** -0.5),
                       bound(nbytes, flops, dtype_name(dtype)))
                records[-1].update(limit=formula, worst_of_limit=worst)


def dequant_int4(torch, packed, scale, group):
    from psalm_tpu_torch.ops.int4_matvec import unpack_int4
    low, high = unpack_int4(packed)
    q = torch.cat([low, high], 0).float()  # [K, N]
    K, N = q.shape
    return (q.reshape(K // group, group, N) * scale[:, None, :]).reshape(K, N)


def int4pack_call(torch, packed, scale, group, want_fn):
    """torch._weight_int4pack_mm on a repacked copy of K4's weight (PyTorch's
    own int4 GEMM: uint8 q + 8 along K in pairs, bf16 scales and zero
    points), as a second yardstick for K4; None where this torch lacks it,
    refuses the shape, or disagrees with the plain version by more than the
    bf16 rounding of its scales allows."""
    from psalm_tpu_torch.ops.int4_matvec import unpack_int4
    try:
        low, high = unpack_int4(packed)
        q = (torch.cat([low, high], 0).t() + 8).to(torch.int32)  # [N, K]
        w_uint8 = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8).contiguous()
        w = torch._convert_weight_to_int4pack(w_uint8, 8)
        sz = torch.stack([scale, torch.zeros_like(scale)], -1).to(
            torch.bfloat16).contiguous()  # [K/g, N, 2]

        def call(x):
            return torch._weight_int4pack_mm(x, w, group, sz)

        x, want = want_fn()
        err = ((call(x).float() - want).abs().max() / want.abs().max()).item()
        if not err <= 2e-2:
            log(f"  (_weight_int4pack_mm disagrees: {err:.3e}; not timed)")
            return None
        return call
    except (AttributeError, RuntimeError, TypeError) as e:
        log(f"  (_weight_int4pack_mm not available here: {type(e).__name__}: "
            f"{str(e)[:120]})")
        return None


def check_k4(torch, int4_matvec, records):
    from psalm_tpu_torch.models.quant import quantize_kernel_int4
    dev, group = "cuda", 64
    g = torch.Generator(device=dev).manual_seed(4)
    for K, N, which in K4_SHAPES:
        w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
        packed, scale = quantize_kernel_int4(w, group)
        pow2 = torch.exp2(torch.randint(-4, 3, scale.shape, generator=g,
                                        device=dev).float())
        w_deq = dequant_int4(torch, packed, scale, group)
        # checked once, as Quant4Dense checks its weight: the timed calls
        # (call_ms) are the decode step's
        int4_matvec.check_weight(packed, scale, K, group)
        for B in (1, 4, 16):
            x32 = torch.randn(B, K, generator=g, device=dev)
            hot32 = torch.zeros(B, K, device=dev)
            hot32[torch.arange(B, device=dev),
                  torch.randperm(K, generator=g, device=dev)[:B]] = 1.0
            for dtype in (torch.bfloat16, torch.float32):
                x, hot = x32.to(dtype), hot32.to(dtype)
                name = (f"K4 int4_matvec {dtype_name(dtype)} {which} B={B} "
                        f"K={K} N={N} g={group}")
                got = int4_matvec.int4_matvec(x, packed, scale, group)
                want = int4_matvec.int4_matvec_ref(x, packed, scale, group)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                # f32 sums in another order: 1e-5 of the output's size
                tol = 1e-5 * want.abs().max().item()
                if not err <= tol:
                    fail(f"{name}: max abs err {err} > {tol} ({err / tol:.4g}x)")
                got = int4_matvec.int4_matvec(hot, packed, pow2, group)
                want_hot = int4_matvec.int4_matvec_ref(hot, packed, pow2, group)
                if not torch.equal(got, want_hot):
                    fail(f"{name}: not exact on one-hot rows, max err "
                         f"{(got - want_hot).abs().max().item()}")
                w_lib = w_deq.to(dtype)
                nbytes = x.numel() * x.element_size() + packed.numel() \
                    + scale.numel() * 4 + B * N * 4

                def call():
                    return int4_matvec.int4_matvec(x, packed, scale, group,
                                                   weight_checked=True)

                events, _ = device_trace(
                    lambda: [call() for _ in range(K4_TRACED_CALLS)], name)
                names = sorted({e.name for e in events})
                if len(events) != K4_TRACED_CALLS or not all(
                        "int4_matvec_kernel" in n for n in names):
                    fail(f"{name}: {len(events)} device events in "
                         f"{K4_TRACED_CALLS} calls ({names}), not one K4 "
                         "kernel a call")
                record(records, "K4", name, err, tol, call,
                       lambda: int4_matvec.int4_matvec_ref(x, packed, scale,
                                                           group),
                       lambda: torch.matmul(x, w_lib),
                       # int4 values are exact in bf16: x's type sets the rate
                       bound(nbytes, 2 * B * K * N, dtype_name(dtype)))
                records[-1]["kernels_per_call"] = len(events) / K4_TRACED_CALLS
                if dtype == torch.bfloat16:
                    if B == 1:  # built and checked once per weight
                        int4pack = int4pack_call(torch, packed, scale, group,
                                                 lambda: (x, want))
                    records[-1]["int4pack_ms"] = (
                        device_ms(lambda: int4pack(x)) if int4pack else None)
                    log(f"    _weight_int4pack_mm: "
                        f"{records[-1]['int4pack_ms']} ms")


def k5_limit(flash_attention, q, k, v, want, **kw):
    """K5's per-element limit on |got - want| and its formula: in bf16 one
    bf16 step of the output plus the rounding of P before P v (the kernel
    rounds P where the stock kernel does; ``bf16_limit``), in f32 1e-5 of
    the size (sums in another order)."""
    import torch
    if q.dtype == torch.bfloat16:
        mag = flash_attention.flash_attention_magnitude(q, k, v, **kw)
        return (flash_attention.bf16_limit(want, mag, 1e-5),
                "2^-7 |want| + 2^-8 P|v| + 1e-5")
    return 1e-5 * want.abs() + 1e-5, "1e-5 |want| + 1e-5"


def check_k5(torch, flash_attention, records):
    import torch.nn.functional as F
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    cases = [(32, 640, 64, True, torch.bfloat16),   # Phi, eval batch
             (32, 640, 64, True, torch.float32),
             (32, 577, 64, True, torch.bfloat16),   # no tile multiple
             (32, 577, 64, True, torch.float32),
             (8, 21504, 32, False, torch.bfloat16),  # dense encoder
             (2, 21504, 128, False, torch.bfloat16)]
    for h, L, hd, causal, dtype in cases:
        q, k, v = (torch.randn(1, h, L, hd, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        kw = dict(causal=causal, sm_scale=hd ** -0.5)
        got = flash_attention.flash_attention(q, k, v, **kw).float()
        want = flash_attention.flash_attention_ref(q, k, v, **kw).float()
        kernel = "K5 causal" if causal else "K5 non-causal"
        name = (f"{kernel} flash_attention {dtype_name(dtype)} B=1 h={h} "
                f"L={L} hd={hd}")
        limit, formula = k5_limit(flash_attention, q, k, v, want, **kw)
        diff = (got - want).abs()
        worst = (diff / limit).max().item()
        log(f"  {name}: |out| max {want.abs().max().item():.4e}, rms "
            f"{want.square().mean().sqrt().item():.4e}; largest |got - want| "
            f"is {worst:.4f} of its limit {formula}")
        if not worst <= 1.0:
            fail(f"{name}: |got - want| exceeds {formula} by {worst}x")
        nbytes = 4 * q.numel() * q.element_size()  # q, k, v read, out written
        flops = 4 * h * L * L * hd // (2 if causal else 1)
        record(records, kernel, name, diff.max().item(), limit.max().item(),
               lambda: flash_attention.flash_attention(q, k, v, **kw),
               lambda: flash_attention.flash_attention_ref(q, k, v, **kw),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, scale=hd ** -0.5),
               bound(nbytes, flops, dtype_name(dtype)))
        records[-1]["limit"] = formula
        records[-1]["worst_of_limit"] = worst


def check_k2(torch, msdeform, records):
    """K2 against autograd through the plain sampler, K1's inputs with the
    offsets moved off whole pixels and off the clip."""
    shapes, loc, value32, attn32, g = deform_inputs(torch, 2,
                                                    off_whole_pixels=True)
    B, S, M, D = value32.shape
    L, P = loc.shape[3], loc.shape[4]
    grad32 = torch.randn(B, S, M * D, generator=g, device="cuda")
    starts = msdeform.level_starts(shapes)
    for dtype in (torch.bfloat16, torch.float32):
        value, attn, grad = (t.to(dtype).contiguous()
                             for t in (value32, attn32, grad32))
        elt = value.element_size()
        # read value, loc, attn and the output gradient, write d value, d
        # loc and d attn; about 30 operations per channel and sample (four
        # tap weights, three sums over the taps, four scatter products)
        nbytes = 2 * (value.numel() * elt + loc.numel() * 4
                      + attn.numel() * elt) + grad.numel() * elt
        flops = B * S * M * L * P * D * 30
        for radius in (None, 8.0):
            args = (value, shapes, starts, loc, attn, grad)
            got = msdeform.ms_deform_attn_bwd(*args, radius=radius)
            want = msdeform.ms_deform_attn_bwd_ref(*args, radius=radius)
            mag = msdeform.ms_deform_attn_bwd_magnitude(*args, radius=radius)
            limits = msdeform.ms_deform_attn_bwd_limit(want, mag, dtype)
            torch.cuda.synchronize()
            name = f"K2 ms_deform_attn_bwd {dtype_name(dtype)} radius={radius}"
            log(f"  {name}: terms an element (d value, d loc, d attn) "
                f"{mag[1]}")
            held = {}
            for what, a, b, lim in zip(("d_value", "d_loc", "d_attn"), got,
                                       want, limits):
                rounded = dtype == torch.bfloat16 and what != "d_loc"
                held[what] = hold(f"{name} {what}", a, b, lim,
                                  K2_LIMITS[rounded])
            del mag, limits
            record(records, "K2", name, *held["d_value"][:2],
                   lambda: msdeform.ms_deform_attn_bwd(*args, radius=radius),
                   lambda: msdeform.ms_deform_attn_bwd_ref(*args,
                                                           radius=radius),
                   None, bound(nbytes, flops, dtype_name(dtype)))
            records[-1].update(limit=K2_LIMITS[dtype == torch.bfloat16],
                               worst_of_limit={k: v[2]
                                               for k, v in held.items()})


def check_k5_bwd(torch, flash_attention, records):
    """The K5 backward against the plain chunked backward, both from the
    kernel forward's out and log-sum-exp."""
    import torch.nn.functional as F
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(6)
    cases = [(32, 640, 64, True),      # Phi with use_flash, eval batch
             (2, 21504, 128, False),   # the dense training shape
             (8, 21504, 32, False)]
    for h, L, hd, causal in cases:
        dtype = torch.bfloat16
        q, k, v, do = (torch.randn(1, h, L, hd, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        scale = hd ** -0.5
        out, lse = flash_attention._forward(q, k, v, causal, scale,
                                            with_lse=True)
        args = (q, k, v, out, lse, do)
        kw = dict(causal=causal, sm_scale=scale)
        got = flash_attention.flash_attention_bwd(*args, **kw)
        want = flash_attention.flash_attention_bwd_ref(*args, **kw)
        torch.cuda.synchronize()
        kernel = "K5 backward " + ("causal" if causal else "non-causal")
        name = f"{kernel} flash_attention_bwd bf16 B=1 h={h} L={L} hd={hd}"
        # per element: one bf16 step, the rounding of P (dv) or dS (dq, dk)
        # before its product, and 1e-5 of the largest |want|
        mags = flash_attention.flash_attention_bwd_magnitude(*args, **kw)
        worst, limits = {}, {}
        for w, a, b, mag in zip(("dq", "dk", "dv"), got, want, mags):
            b = b.float()
            limits[w] = flash_attention.bf16_limit(b, mag, 1e-5 * b.abs().max())
            worst[w] = ((a.float() - b).abs() / limits[w]).max().item()
        log(f"  {name}: worst element at {worst} of its limit 2^-7 |want| "
            f"+ 2^-8 magnitude + 1e-5 max |want|")
        if not max(worst.values()) <= 1.0:
            fail(f"{name}: an element exceeds its limit: {worst}")
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ref_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                 scale=scale)

        def library():
            torch.autograd.grad(ref_out, (qs, ks, vs), do, retain_graph=True)

        # read q, k, v, out, dout and lse, write dq, dk and dv; five [L, L]
        # products (half of them under the causal mask)
        nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
        flops = 10 * h * L * L * hd // (2 if causal else 1)
        dq, dq_want = got[0].float(), want[0].float()
        record(records, kernel, name, (dq - dq_want).abs().max().item(),
               limits["dq"].max().item(),
               lambda: flash_attention.flash_attention_bwd(*args, **kw),
               lambda: flash_attention.flash_attention_bwd_ref(*args, **kw),
               library, bound(nbytes, flops, "bfloat16"))
        records[-1]["limit"] = ("2^-7 |want| + 2^-8 magnitude + 1e-5 max "
                                "|want|")
        records[-1]["worst_of_limit"] = worst
        del ref_out, qs, ks, vs, mags, limits


# the bf16 tensor-core kernels, each at every head dim it is instantiated
# for: K5's forward, dK/dV and dQ, and K3
TENSOR_CORE_KERNELS = {"flash_attention_tc_kernel": (32, 64, 128),
                       "flash_bwd_dkv_tc_kernel": (32, 64, 128),
                       "flash_bwd_dq_tc_kernel": (32, 64, 128),
                       "window_attention_tc_kernel": (16, 32)}


def cuobjdump(nvcc):
    """The toolkit's cuobjdump beside nvcc, or on PATH; fails without it."""
    import shutil
    cand = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    found = cand if os.path.exists(cand) else shutil.which("cuobjdump")
    if found is None:
        fail("cuobjdump not found beside nvcc or on PATH: cannot show that "
             "K3 and K5 run on the tensor cores, K1 loads 16 bytes and K2 "
             "reduces by vectors")
    return found


# K1's and K2's instantiations in the built library: (fwd or bwd, element
# type, channels a thread, L, P, clamp); kL = 3, kP = 4 is the model's
SAMPLER_KERNEL = (r"msdeform_(fwd|bwd)_kernelI(13__nv_bfloat16|f)Li(\d+)ELi"
                  r"(\d+)ELi(\d+)ELb([01])E")


def check_sass(lib_path, nvcc):
    """From the built library's SASS (cuobjdump): the bf16 K5 forward, dK/dV
    and dQ kernels and the bf16 K3 kernel hold tensor-core instructions
    (HMMA: mma.sync; HGMMA: wgmma), at every head dim; every K1
    instantiation with channel vectors reads value by 16-byte loads
    (LDG.E.128) and every such K2 instantiation reduces d value by vector
    reductions only (REDG.E.ADD.F32x4, no scalar REDG); the model's K1 and
    K2 instantiations (L = 3, P = 4) do not spill. Logs each K1-K5 kernel's
    registers, stack, local memory (spills) and static shared memory."""
    import re
    tool = cuobjdump(nvcc)

    def run(*args):
        proc = subprocess.run([tool, *args, str(lib_path)], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"cuobjdump {' '.join(args)} failed: {proc.stderr[-500:]}")
        return proc.stdout

    counts = {}
    name = None
    patterns = {"mma": r"\bH(G)?MMA\b", "ldg128": r"\bLDG\.E\.128\b",
                "red_v4": r"\bREDG?\.E\.ADD\.F32x4\b",
                "red_scalar": r"\bREDG?\.E\.ADD\.F32\.",
                "atom": r"\bATOMG?\."}
    for line in run("-sass").splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = dict.fromkeys(patterns, 0)
        elif name is not None:
            for key, pat in patterns.items():
                if re.search(pat, line):
                    counts[name][key] += 1
    for kernel, head_dims in TENSOR_CORE_KERNELS.items():
        for hd in head_dims:
            hits = [c["mma"] for f, c in counts.items() if f"{kernel}ILi{hd}E" in f]
            if not hits or min(hits) == 0:
                fail(f"{kernel}<{hd}>: no HMMA/HGMMA in its SASS ({hits})")
            log(f"  {kernel}<{hd}>: {hits} tensor-core instructions "
                f"(HMMA/HGMMA) in its SASS, per instantiation")
    sampler = {}
    for f, c in counts.items():
        found = re.search(SAMPLER_KERNEL, f)
        if not found:
            continue
        which, elt, kv = found.group(1), found.group(2), int(found.group(3))
        sampler[f] = found.groups()
        tag = (f"  K{1 if which == 'fwd' else 2} {'bf16' if elt != 'f' else 'f32'}"
               f" {kv} channels a thread, L={found.group(4)} P={found.group(5)}"
               f" clamp={found.group(6)}")
        log(f"{tag}: LDG.E.128 {c['ldg128']}, REDG.E.ADD.F32x4 {c['red_v4']},"
            f" scalar REDG.E.ADD.F32 {c['red_scalar']}, ATOM {c['atom']}")
        if kv > 1 and which == "fwd" and c["ldg128"] == 0:
            fail(f"{tag}: no 16-byte loads (LDG.E.128) in its SASS")
        if kv > 1 and which == "bwd" and (c["red_v4"] == 0 or c["red_scalar"]
                                          or c["atom"]):
            fail(f"{tag}: d value not by vector reductions alone ({c})")
    # 2 kernels x 2 types x 2 widths x 2 sample loops x 2 clamps: else the
    # pattern missed some and their checks did not run
    if len(sampler) != 32:
        fail(f"{len(sampler)} K1/K2 instantiations in the library, not 32")
    usage = run("--dump-resource-usage").splitlines()
    for i, line in enumerate(usage):
        found = re.search(r"Function (\S+):", line)
        if found and i + 1 < len(usage) and any(
                k in found.group(1) for k in ("flash", "window_attention",
                                              "int4_matvec", "msdeform")):
            res = usage[i + 1].strip()
            log(f"  {found.group(1)}: {res}")
            model = sampler.get(found.group(1))
            if model and model[3:5] == ("3", "4") and not (
                    "STACK:0 " in res and "LOCAL:0 " in res):
                fail(f"{found.group(1)}: the model's K1/K2 spills ({res})")


def check_small_slice(torch, np):
    """Tiny config, f32: kernels on the card vs plain versions on the CPU."""
    from psalm_tpu_torch import tiny_test_config
    from psalm_tpu_torch.eval.runner import EvalRunner, synthetic_panoptic_batch
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    cfg = tiny_test_config()
    K = 4
    cpu = init_weights_(PSALM(cfg, device="cpu"),
                        torch.Generator().manual_seed(7))
    with torch.no_grad():  # sampling offsets beyond the init's +-4 px
        for layer in cpu.pixel_decoder.transformer.encoder.layers:
            layer.self_attn.sampling_offsets.bias.mul_(3.0)
    gpu = PSALM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = synthetic_panoptic_batch(cfg, 2, K, (48, 64), (97, 131),
                                     tokens_per_class=2, seed=5)
    runs = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        runner = EvalRunner(model, cfg, num_class_names=K, bucket_hw=(128, 160))
        with torch.no_grad():
            out = model(runner.stage(batch), num_class_names=K)
        runs[name] = (out, runner.infer(batch))
    (c_out, c_res), (g_out, g_res) = runs["cpu"], runs["cuda"]
    for key in ("pred_masks", "pred_class_name_logits"):
        want = c_out[key].double()
        err = (g_out[key].cpu().double() - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"  {key}: max abs err {err:.3e} vs max |x| {scale:.3e}")
        if not err <= 1e-3 * scale:
            fail(f"small slice {key}: err {err} > 1e-3 x {scale}")
    agree = np.mean([np.mean(a == b) for a, b in
                     zip(g_res["panoptic_seg"], c_res["panoptic_seg"])])
    log(f"  panoptic_seg agreement {agree:.6f}")
    if agree < 0.99:
        fail(f"small slice panoptic_seg agreement {agree}")


def small_task_batch(cfg, task, K, seed):
    from psalm_tpu_torch import SegTask
    from psalm_tpu_torch.eval.runner import (synthetic_panoptic_batch,
                                             synthetic_referring_batch,
                                             synthetic_region_batch)
    content, orig = (48, 64), (97, 131)
    if task is SegTask.REFERRING:
        return synthetic_referring_batch(cfg, 2, content, orig, refer_tokens=5,
                                         seed=seed)
    if task is SegTask.REGION:
        return synthetic_region_batch(cfg, 2, content, orig, regions=4,
                                      valid_regions=3, points=32, seed=seed)
    return synthetic_panoptic_batch(cfg, 2, K, content, orig,
                                    tokens_per_class=2, seed=seed)


def ranked_agree(np, got, want, name):
    """Items of a ranked head (instance, referring) held item by item where
    the CPU's scores are 1e-3 apart from their neighbours: class or query
    equal and masks agreeing on 99% of pixels. Scores within 1e-3 of the
    largest."""
    for b in range(len(want["masks"])):
        ws, gs = want["scores"][b], got["scores"][b]
        tol = 1e-3 * max(np.abs(ws).max(), 1e-6)
        if not np.abs(np.sort(gs) - np.sort(ws)).max() <= tol:
            fail(f"small {name}: scores differ beyond {tol}")
        gap = np.abs(np.diff(ws)) > tol
        apart = np.concatenate([[True], gap]) & np.concatenate([gap, [True]])
        if not apart.any():
            fail(f"small {name}: no ranked item to compare")
        for i in np.flatnonzero(apart):
            for key in ("classes", "query"):
                if key in want and got[key][b][i] != want[key][b][i]:
                    fail(f"small {name}: {key} differs at rank {i}")
            agree = np.mean(got["masks"][b][i] == want["masks"][b][i])
            if agree < 0.99:
                fail(f"small {name}: mask at rank {i} agrees on {agree}")


def check_small_tasks(torch, np):
    """Tiny config with Phi's use_flash (2 heads of 32) in f32: the four
    tasks, and the panoptic task with the dense pixel decoder (1 head of
    32), kernels on the card against the plain versions on the CPU."""
    import dataclasses
    from psalm_tpu_torch import SegTask, tiny_test_config
    from psalm_tpu_torch.eval.runner import EvalRunner
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    base = tiny_test_config()
    base = base.replace(phi=dataclasses.replace(base.phi, num_heads=2))
    K = 4
    for task, mode in ((SegTask.SEMANTIC, "deformable"),
                       (SegTask.INSTANCE, "deformable"),
                       (SegTask.REFERRING, "deformable"),
                       (SegTask.REGION, "deformable"),
                       (SegTask.PANOPTIC, "dense")):
        cfg = base.replace(seg_task=task, pixel_decoder=dataclasses.replace(
            base.pixel_decoder, attention_mode=mode,
            transformer_nheads=1 if mode == "dense" else 4))
        name = f"{task.value}/{mode}"
        cpu = init_weights_(PSALM(cfg, device="cpu", use_flash=True),
                            torch.Generator().manual_seed(7))
        gpu = PSALM(cfg, device="cuda", use_flash=True)
        gpu.load_state_dict(cpu.state_dict())
        batch = small_task_batch(cfg, task, K, seed=8)
        flags = dict(use_class_names=task in (SegTask.PANOPTIC,
                                              SegTask.SEMANTIC,
                                              SegTask.INSTANCE),
                     use_seg_embedding=task is SegTask.REFERRING,
                     use_regions=task is SegTask.REGION,
                     num_class_names=K)
        runs = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            runner = EvalRunner(model, cfg, num_class_names=K,
                                bucket_hw=(128, 160))
            zero_counts()
            with torch.no_grad():
                out = model(runner.stage(batch), **flags)
            runs[dev] = (out, runner.infer(batch), launch_counts())
        (c_out, c_res, _), (g_out, g_res, counts) = runs["cpu"], runs["cuda"]
        layers = 2 * cfg.phi.num_layers  # two forwards of the model
        if counts["K5 causal"] != layers or counts["K5 non-causal"] != (
                2 * cfg.pixel_decoder.transformer_enc_layers
                if mode == "dense" else 0):
            fail(f"small {name}: K5 launches {counts}")
        logit = {SegTask.REFERRING: "pred_SEG_logits",
                 SegTask.REGION: "pred_region_logits"}.get(
                     task, "pred_class_name_logits")
        for key in ("pred_masks", logit):
            want = c_out[key].double()
            want = torch.where(want == -1e9, torch.zeros_like(want), want)
            got = g_out[key].cpu().double()
            got = torch.where(got == -1e9, torch.zeros_like(got), got)
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if not err <= 1e-3 * scale:
                fail(f"small {name} {key}: err {err} > 1e-3 x {scale}")
        maps = [k for k in ("panoptic_seg", "sem_seg") if k in c_res]
        for key in maps:
            agree = np.mean([np.mean(a == b) for a, b in
                             zip(g_res[key], c_res[key])])
            if agree < 0.99:
                fail(f"small {name} {key} agreement {agree}")
        if task is SegTask.REGION:
            g, w = g_res["region"], c_res["region"]
            err = np.abs(g["scores"] - w["scores"]).max()
            agree = np.mean([np.mean(a == b) for a, b in
                             zip(g["masks"], w["masks"])])
            if not (err <= 1e-3 * np.abs(w["scores"]).max() and agree >= 0.99):
                fail(f"small {name}: scores err {err}, masks agree {agree}")
        elif task in (SegTask.INSTANCE, SegTask.REFERRING):
            key = "instances" if task is SegTask.INSTANCE else "referring"
            ranked_agree(np, g_res[key], c_res[key], name)
        log(f"  {name}: logits within 1e-3, maps/masks agree; launches "
            f"{counts}")


def eval_slice(torch, np, card, path_ms):
    """Phase 5; returns the kernels' launches in the timed run and keeps
    K1's device ms per launch in ``path_ms``."""
    from psalm_tpu_torch import PSALMConfig
    from psalm_tpu_torch.eval.runner import EvalRunner, synthetic_panoptic_batch
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    cfg = PSALMConfig(compute_dtype="bfloat16")
    K = cfg.num_classes + 1
    t0 = time.perf_counter()
    model = PSALM(cfg, dtype=torch.bfloat16, device="cuda")
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    model.to(torch.bfloat16)  # bf16 parameter storage, as bench.py keeps it
    n_params = sum(p.numel() for p in model.parameters())
    batch = synthetic_panoptic_batch(cfg, 1, K, CONTENT_HW, ORIGINAL_HW)
    runner = EvalRunner(model, cfg, num_class_names=K,
                        is_thing=[i % 2 == 0 for i in range(K - 1)],
                        bucket_hw=BUCKET_HW)
    log(f"model: {n_params / 1e9:.3f} B parameters, sequence "
        f"{batch['tok_ids'].shape[1]}, set up in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        out = model(runner.stage(batch), num_class_names=K)
    pm, cl = out["pred_masks"], out["pred_class_name_logits"]
    S4 = cfg.image_size // 4
    if tuple(pm.shape) != (1, cfg.mask_decoder.num_queries, S4, S4) \
            or tuple(cl.shape) != (1, cfg.mask_decoder.num_queries, K):
        fail(f"output shapes {tuple(pm.shape)} {tuple(cl.shape)}")
    if not (torch.isfinite(pm.float()).all() and torch.isfinite(cl.float()).all()):
        fail("non-finite pred_masks or class logits")
    times, wall, launches, res = timed_images(torch, runner, batch, 2,
                                              TIMED_IMAGES)
    expect = expected(K1=cfg.pixel_decoder.transformer_enc_layers
                      * TIMED_IMAGES, K3=sum(cfg.swin.depths) * TIMED_IMAGES)
    log(f"launches in the timed run: {launches} (expected {expect})")
    if launches != expect:
        fail(f"kernel launches {launches} != {expect}")
    pan, sem = res["panoptic_seg"][0], res["sem_seg"][0]
    if pan.shape != ORIGINAL_HW or sem.shape != ORIGINAL_HW:
        fail(f"panoptic_seg {pan.shape} / sem_seg {sem.shape} != {ORIGINAL_HW}")
    seg = res["segments"]
    log(f"panoptic: {int(seg['valid'].sum())} segments, ids "
        f"{np.unique(pan).tolist()[:10]}; sem_seg classes "
        f"{np.unique(sem).tolist()[:10]}")
    p50 = sorted(times)[len(times) // 2]
    log(f"eval slice: p50 {p50 * 1e3:.2f} ms, {TIMED_IMAGES / wall:.3f} img/s "
        f"({TIMED_IMAGES} images, batch 1, bf16) on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    sampler_ms(lambda: runner.infer(batch), "eval", path_ms)
    return launches


def timed_images(torch, runner, batch, warmup, n):
    """``warmup`` images, then ``n`` timed ones with the counters zeroed
    just before: (per-image seconds, wall seconds, launches, last result)."""
    for _ in range(warmup):
        runner.infer(batch)
    torch.cuda.synchronize()
    zero_counts()
    times = []
    t_all = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        res = runner.infer(batch)  # ends in a device-to-host copy
        times.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    return times, wall, launch_counts(), res


def check_task_result(np, task, res, Q, K):
    """Shapes, ranges and finiteness of one task's result at the original
    size."""
    from psalm_tpu_torch import SegTask
    H, W = ORIGINAL_HW
    if task in (SegTask.SEMANTIC, SegTask.PANOPTIC):
        sem = res["sem_seg"][0]
        if sem.shape != ORIGINAL_HW or sem.max() >= K - 1:
            fail(f"{task.value}: sem_seg {sem.shape}, max {sem.max()}")
        return f"sem_seg classes {np.unique(sem).tolist()[:10]}"
    key = {SegTask.INSTANCE: "instances", SegTask.REFERRING: "referring",
           SegTask.REGION: "region"}[task]
    r = res[key]
    masks, scores = r["masks"][0], r["scores"][0]
    want_scores = (Q, REGIONS) if task is SegTask.REGION else (Q,)
    if masks.shape != (Q, H, W) or masks.dtype != bool \
            or scores.shape != want_scores or not np.isfinite(scores).all() \
            or scores.min() < 0 or scores.max() > 1:
        fail(f"{task.value}: masks {masks.shape} {masks.dtype}, scores "
             f"{scores.shape} in [{scores.min()}, {scores.max()}]")
    if task is SegTask.REGION and (scores[:, REGIONS - 1] != 0).any():
        fail("region: the invalid region slot has nonzero scores")
    return (f"top score {scores.max():.4f}, {int(masks[0].sum())} pixels in "
            f"the first mask")


def task_slice(torch, np, card):
    """Phase 7; returns each task's launches in its timed run."""
    from psalm_tpu_torch import PSALMConfig, SegTask
    from psalm_tpu_torch.eval.runner import (EvalRunner, synthetic_panoptic_batch,
                                             synthetic_referring_batch,
                                             synthetic_region_batch)
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    cfg = PSALMConfig(compute_dtype="bfloat16")
    K = cfg.num_classes + 1
    Q = cfg.mask_decoder.num_queries
    model = PSALM(cfg, dtype=torch.bfloat16, device="cuda", use_flash=True)
    init_weights_(model, torch.Generator(device="cuda").manual_seed(2))
    model.to(torch.bfloat16)
    batches = {
        SegTask.SEMANTIC: synthetic_panoptic_batch(cfg, 1, K, CONTENT_HW,
                                                   ORIGINAL_HW),
        SegTask.INSTANCE: synthetic_panoptic_batch(cfg, 1, K, CONTENT_HW,
                                                   ORIGINAL_HW),
        SegTask.REFERRING: synthetic_referring_batch(
            cfg, 1, CONTENT_HW, ORIGINAL_HW, refer_tokens=REFER_TOKENS),
        # the last slot is padding (region_valid False), as the region
        # dataset pads its prompts
        SegTask.REGION: synthetic_region_batch(
            cfg, 1, CONTENT_HW, ORIGINAL_HW, regions=REGIONS,
            valid_regions=REGIONS - 1, points=REGION_POINTS)}
    per_image = expected(K1=cfg.pixel_decoder.transformer_enc_layers,
                         K3=sum(cfg.swin.depths),
                         K5_causal=cfg.phi.num_layers)
    launches = {}
    for task, batch in batches.items():
        runner = EvalRunner(model, cfg.replace(seg_task=task),
                            num_class_names=K, bucket_hw=BUCKET_HW)
        times, wall, counts, res = timed_images(torch, runner, batch,
                                                TASK_WARMUP, TASK_IMAGES)
        expect = {k: v * TASK_IMAGES for k, v in per_image.items()}
        if counts != expect:
            fail(f"{task.value}: kernel launches {counts} != {expect}")
        what = check_task_result(np, task, res, Q, K)
        p50 = sorted(times)[len(times) // 2]
        log(f"{task.value}: p50 {p50 * 1e3:.2f} ms, {TASK_IMAGES / wall:.3f} "
            f"img/s ({TASK_IMAGES} images, batch 1, bf16, sequence "
            f"{batch['tok_ids'].shape[1]}) on {card}; {what}; launches "
            f"{counts}")
        launches[f"tasks/{task.value}"] = counts
    log(f"tasks peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def dense_slice(torch, np, card):
    """Phase 8; returns the launches of its timed run."""
    import dataclasses
    from psalm_tpu_torch import PSALMConfig
    from psalm_tpu_torch.eval.runner import EvalRunner, synthetic_panoptic_batch
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    base = PSALMConfig(compute_dtype="bfloat16")
    cfg = base.replace(pixel_decoder=dataclasses.replace(
        base.pixel_decoder, attention_mode="dense"))
    K = cfg.num_classes + 1
    model = PSALM(cfg, dtype=torch.bfloat16, device="cuda", use_flash=True)
    init_weights_(model, torch.Generator(device="cuda").manual_seed(3))
    model.to(torch.bfloat16)
    batch = synthetic_panoptic_batch(cfg, 1, K, CONTENT_HW, ORIGINAL_HW)
    runner = EvalRunner(model, cfg, num_class_names=K,
                        is_thing=[i % 2 == 0 for i in range(K - 1)],
                        bucket_hw=BUCKET_HW)
    times, wall, counts, res = timed_images(torch, runner, batch, TASK_WARMUP,
                                            TASK_IMAGES)
    expect = expected(K3=sum(cfg.swin.depths) * TASK_IMAGES,
                      K5_causal=cfg.phi.num_layers * TASK_IMAGES,
                      K5_non_causal=cfg.pixel_decoder.transformer_enc_layers
                      * TASK_IMAGES)
    if counts != expect:
        fail(f"dense: kernel launches {counts} != {expect}")
    pan = res["panoptic_seg"][0]
    if pan.shape != ORIGINAL_HW:
        fail(f"dense: panoptic_seg {pan.shape} != {ORIGINAL_HW}")
    what = check_task_result(np, cfg.seg_task, res, 0, K)
    p50 = sorted(times)[len(times) // 2]
    pd = cfg.pixel_decoder
    S = sum((cfg.image_size // s) ** 2 for s in (8, 16, 32))
    log(f"dense panoptic: p50 {p50 * 1e3:.2f} ms, {TASK_IMAGES / wall:.3f} "
        f"img/s ({TASK_IMAGES} images, batch 1, bf16, "
        f"{pd.transformer_nheads} heads of {pd.conv_dim // pd.transformer_nheads}"
        f" over S={S}) on {card}; {int(res['segments']['valid'].sum())} "
        f"segments, {what}; launches {counts}")
    return {"dense": counts}


def train_args(**kw):
    """The trainer's arguments (psalm_tpu_torch.train.train.parse_args's
    names): lr 6e-5 cosine after 3% warmup over 1000 steps, batch 1, bf16
    compute, gradient checkpointing."""
    import argparse
    base = dict(output_dir=os.path.join(HERE, "build", "train"),
                learning_rate=6e-5, warmup_ratio=0.03, weight_decay=0.0,
                num_train_steps=1000, per_device_train_batch_size=1,
                save_steps=10 ** 9, save_total_limit=1, logging_steps=1,
                gradient_checkpointing=True, bf16=True, seed=0,
                seg_task="panoptic", pixel_decoder_mode="deformable")
    base.update(kw)
    return argparse.Namespace(**base)


def fixed_draws(np, cfg, B):
    """One U[0, 1) array per point-draw shape of the criterion, the same on
    every device and step (numpy, seed 11)."""
    c = cfg.loss
    P = c.train_num_points
    rng = np.random.default_rng(11)
    return {s: rng.uniform(size=s).astype(np.float32)
            for s in ((B, P, 2), (B, int(P * c.oversample_ratio), 2),
                      (B, P - int(c.importance_sample_ratio * P), 2))}


def train_small(torch, np):
    """Phase 9; returns each mode's launches on the card."""
    import dataclasses
    from psalm_tpu_torch import tiny_test_config
    from psalm_tpu_torch.data.datasets import SyntheticPanopticDataset, collate
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.train.train import Trainer
    base = tiny_test_config()
    base = base.replace(phi=dataclasses.replace(base.phi, num_heads=2))
    K, steps, launches = 4, 2, {}
    for mode in ("deformable", "dense"):
        cfg = base.replace(pixel_decoder=dataclasses.replace(
            base.pixel_decoder, attention_mode=mode,
            transformer_nheads=1 if mode == "dense" else 4))
        flash = mode == "dense"  # Phi's use_flash too: K5 causal both ways
        ds = SyntheticPanopticDataset(cfg.image_size,
                                      cfg.mask_decoder.num_queries, K,
                                      num_samples=2, num_masks=3,
                                      valid_masks=2, seed=3)
        batch = collate([ds[0], ds[1]])
        draws = fixed_draws(np, cfg, 2)
        cpu = init_weights_(PSALM(cfg, device="cpu", use_flash=flash,
                                  remat=True), torch.Generator().manual_seed(9))
        with torch.no_grad():  # sampling offsets beyond the init's +-4 px
            for layer in cpu.pixel_decoder.transformer.encoder.layers:
                if mode == "deformable":
                    layer.self_attn.sampling_offsets.bias.mul_(3.0)
        runs = {}
        for dev in ("cpu", "cuda"):
            model = PSALM(cfg, device=dev, use_flash=flash, remat=True)
            model.load_state_dict(cpu.state_dict())
            trainer = Trainer(train_args(bf16=False, warmup_ratio=0.1,
                                         num_train_steps=10), cfg,
                              model=model, device=dev,
                              uniform_fn=lambda _, shape: draws[tuple(shape)])
            zero_counts()
            runs[dev] = ([{k: float(v) for k, v in trainer.step(batch).items()}
                          for _ in range(steps)], launch_counts())
        (want, _), (got, counts) = runs["cpu"], runs["cuda"]
        for i, (w, g) in enumerate(zip(want, got)):
            for key in ("loss_mask", "loss_dice", "loss_class_name_class",
                        "loss", "grad_norm"):
                if not abs(g[key] - w[key]) <= 1e-3 * abs(w[key]):
                    fail(f"small training {mode} step {i} {key}: card "
                         f"{g[key]} vs CPU {w[key]}")
        enc, phi = (cfg.pixel_decoder.transformer_enc_layers,
                    cfg.phi.num_layers)
        per_step = (dict(K5_non_causal=2 * enc, K5_backward_non_causal=enc,
                         K5_causal=2 * phi, K5_backward_causal=phi)
                    if flash else dict(K1=2 * enc, K2=enc))
        expect = expected(K3=sum(cfg.swin.depths) * steps,
                          **{k: v * steps for k, v in per_step.items()})
        if counts != expect:
            fail(f"small training {mode}: launches {counts} != {expect}")
        log(f"  {mode}{' + use_flash' if flash else ''}: {steps} steps, "
            f"losses and grad norm within 1e-3 of the CPU (loss "
            f"{got[-1]['loss']:.6f} vs {want[-1]['loss']:.6f}, grad norm "
            f"{got[-1]['grad_norm']:.6f} vs {want[-1]['grad_norm']:.6f}); "
            f"launches {counts}")
        launches[f"train small/{mode}"] = counts
    return launches


def train_slice(torch, np, card, mode, path_ms):
    """Phases 10 and 11: the Trainer at the full published width; returns
    the launches of the timed steps and keeps K1's and K2's device ms per
    launch in ``path_ms`` (deformable)."""
    import dataclasses
    from psalm_tpu_torch.data.datasets import (SyntheticPanopticDataset,
                                               UnifiedTaskSampler, collate)
    from psalm_tpu_torch.train.train import Trainer, build_train_config
    args = train_args(pixel_decoder_mode=mode)
    cfg = build_train_config(args)  # dense: 2 heads of 128
    K, timed = cfg.num_classes + 1, 3
    t0 = time.perf_counter()
    gc.collect()  # the last phase's model and trainer (reference cycles)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    trainer = Trainer(args, cfg, device="cuda")
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  K, num_samples=4, num_masks=16)
    sampler = UnifiedTaskSampler([ds], batch_size=1)
    batches = [collate(sampler.next_batch()) for _ in range(1 + timed)]
    n_params = sum(p.numel() for p in trainer.model.parameters())
    n_train = sum(p.numel() for _, p in trainer.trainable)
    torch.cuda.synchronize()
    log(f"model: {n_params / 1e9:.3f} B parameters (f32), {n_train / 1e9:.3f} "
        f"B trained, sequence {batches[0]['tok_ids'].shape[1]}, "
        f"{ds.num_masks} masks at {cfg.image_size}^2, "
        f"{cfg.loss.train_num_points} points; set up in "
        f"{time.perf_counter() - t0:.1f} s")

    def watched():  # a few parameters: projector, Phi, pixel decoder, tower
        named = dict(trainer.model.named_parameters())
        keys = ["seg_query_projector.weight",
                "model.layers.0.self_attn.q_proj.weight",
                next(n for n in named if n.startswith(
                    "pixel_decoder.transformer.encoder.layers.0.self_attn.")),
                "model.vision_tower.patch_embed.proj.weight"]
        return {k: named[k].detach().clone() for k in keys}

    start = watched()
    t0 = time.perf_counter()
    metrics = trainer.step(batches[0])  # warm-up: lr 0
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after_first = watched()
    if any(not torch.equal(after_first[k], start[k]) for k in start):
        fail(f"train {mode}: the first update (lr 0) changed a parameter")
    zero_counts()
    times = []
    for i, batch in enumerate(batches[1:]):
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            after_second = watched()
    counts = launch_counts()
    values = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"train {mode}: non-finite metrics {values}")
    tower = "model.vision_tower.patch_embed.proj.weight"
    moved = [k for k in start if k != tower
             and not torch.equal(after_second[k], start[k])]
    if len(moved) != len(start) - 1 or not torch.equal(
            trainer.model.get_parameter(tower), start[tower]):
        fail(f"train {mode}: after the second update moved {moved}; the "
             "tower must not move")
    enc = cfg.pixel_decoder.transformer_enc_layers
    per_step = (dict(K5_non_causal=2 * enc, K5_backward_non_causal=enc)
                if mode == "dense" else dict(K1=2 * enc, K2=enc))
    expect = expected(K3=sum(cfg.swin.depths) * timed,
                      **{k: v * timed for k, v in per_step.items()})
    log(f"launches in the {timed} timed steps: {counts} (expected {expect})")
    if counts != expect:
        fail(f"train {mode}: kernel launches {counts} != {expect}")
    pd = cfg.pixel_decoder
    log(f"train {mode}: step ms {[round(t * 1e3, 2) for t in times]} "
        f"(median {sorted(times)[len(times) // 2] * 1e3:.2f}; warm-up "
        f"{warm_s * 1e3:.0f} ms), batch 1, bf16 compute, f32 parameters, "
        f"{pd.transformer_nheads} heads of "
        f"{pd.conv_dim // pd.transformer_nheads}, on {card}; last step "
        + ", ".join(f"{k} {v:.5f}" for k, v in values.items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        f" ({held / 2**30:.2f} GiB held before the phase);"
        f" launches per step "
        + ", ".join(f"{k} {v // timed}" for k, v in counts.items() if v))
    if mode == "deformable":
        sampler_ms(lambda: trainer.step(batches[-1]), f"train/{mode}",
                   path_ms)
    del trainer
    return {f"train/{mode}": counts}


class StubTokenizer:
    """A deterministic character tokenizer for the smoke run (no tokenizer
    files on the card's machine): ids 100 + (code point % 5000), each id
    decoding to "[id]"."""

    eos_token_id = None

    def encode(self, text, add_special_tokens=False):
        return [100 + ord(c) % 5000 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"[{int(i)}]" for i in ids)


CHAT_PROMPTS = ("What is a deformable attention layer?",
                "Describe a sunny beach.",
                "Name three colors.",
                "Count from one to ten, please.")


def chat_batch(np, tokenizer, prompt, image, B=1):
    """The worker's splice of ``prompt`` with an image, repeated B times."""
    from psalm_tpu_torch.data.splicer import splice, stack_samples
    from psalm_tpu_torch.data.tokenization import tokenize_special
    ids = tokenize_special(prompt, tokenizer)
    n_img = (image.shape[1] // 64) ** 2
    pad_len = -(-(len(ids) + n_img + 8) // 64) * 64
    batch = stack_samples([splice(ids, None, num_image_tokens=n_img,
                                  num_seg_queries=1, pad_len=pad_len)] * B)
    batch["images"] = np.repeat(image, B, axis=0)
    return batch


def set_int4_storage(model, storage):
    from psalm_tpu_torch.models.quant import Quant4Dense
    for mod in model.modules():
        if isinstance(mod, Quant4Dense):
            mod.storage = storage


def time_decode(torch, gen, batch):
    """Greedy decode on ``batch``: (prefill ms, decode ms per step, device
    busy share of the decode steps). Host clock around synchronized work;
    the busy share is the device time of a profiled chunk of the same steps
    over that chunk's host time."""
    temp = torch.zeros(batch["tok_ids"].shape[0], device="cuda")
    rng = torch.Generator(device="cuda").manual_seed(0)
    gen.prefill(batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = gen.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    warm, _ = gen.decode_chunk(logits, cache.clone(), temp, 4, rng)
    warm.cpu()  # warm-up
    t0 = time.perf_counter()
    toks, last = gen.decode_chunk(logits, cache, temp, TIMED_STEPS, rng)
    toks.cpu()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    busy_us, wall_us = profiled_us(
        lambda: gen.decode_chunk(last, cache, temp, 8, rng)[0].cpu(),
        "the decode steps")
    return prefill_ms, step_ms, busy_us / wall_us


def serving_slice(torch, np, card):
    """Phase 6; returns the kernels' launches on the serving path."""
    import dataclasses
    from psalm_tpu_torch import PSALMConfig
    from psalm_tpu_torch.models.builder import model_from_state_dict
    from psalm_tpu_torch.models.generation import Generator
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.serve.model_worker import ModelWorker
    base_cfg = PSALMConfig(compute_dtype="bfloat16")
    cfg = base_cfg.replace(phi=dataclasses.replace(base_cfg.phi,
                                                   quant_storage="pallas"))
    t0 = time.perf_counter()
    base = PSALM(cfg, dtype=torch.bfloat16, device="cuda")
    init_weights_(base, torch.Generator(device="cuda").manual_seed(1))
    sd = base.state_dict()
    del base
    models = {mode: model_from_state_dict(sd, cfg, dtype=torch.bfloat16,
                                          device="cuda", **kw)
              for mode, kw in (("int4", {"load_4bit": True}),
                               ("int8", {"load_8bit": True}),
                               ("bf16", {}))}
    del sd
    torch.cuda.synchronize()
    phi_bytes = {m: sum(t.numel() * t.element_size() for t in
                        models[m].model.layers.state_dict().values())
                 for m in models}
    log(f"models built in {time.perf_counter() - t0:.1f} s; Phi layer bytes "
        + ", ".join(f"{m} {b / 2**30:.3f} GiB" for m, b in phi_bytes.items()))

    tokenizer = StubTokenizer()
    worker = ModelWorker(None, None, None, "psalm-int4",
                         image_size=cfg.image_size, load_4bit=True,
                         decode_chunk=DECODE_CHUNK, max_batch=CHAT_THREADS,
                         device="cuda", model=models["int4"],
                         tokenizer=tokenizer)
    gen = worker.generator
    rng = np.random.default_rng(0)
    S = cfg.image_size
    image = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    mm_batch = chat_batch(np, tokenizer, "<image>\nDescribe the image.", image)
    gen.generate(mm_batch, max_new_tokens=2)  # cuBLAS and allocator set-up
    torch.cuda.synchronize()

    # the main path: counters zeroed just before, read just after
    zero_counts()
    gen.prefills = gen.decode_steps = 0
    results, errors = {}, []

    def chat(i):
        try:
            chunks = list(worker.generate_stream({
                "prompt": CHAT_PROMPTS[i], "max_new_tokens": NEW_TOKENS,
                "temperature": 0.0}))
            results[i] = json.loads(chunks[-1][:-1])["text"]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=chat, args=(i,))
               for i in range(CHAT_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    chat_s = time.perf_counter() - t0
    chat_prefills, chat_steps = gen.prefills, gen.decode_steps
    t0 = time.perf_counter()
    mm_toks = gen.generate(mm_batch, max_new_tokens=NEW_TOKENS,
                           chunk_size=DECODE_CHUNK)
    mm_s = time.perf_counter() - t0
    launches = launch_counts()
    expect = expected(K3=sum(cfg.swin.depths) * gen.prefills,
                      K4=6 * cfg.phi.num_layers * gen.decode_steps)
    log(f"chat: {CHAT_THREADS} requests of {NEW_TOKENS} tokens in "
        f"{chat_s:.2f} s ({chat_prefills} prefills, {chat_steps} decode steps,"
        f" {CHAT_THREADS * NEW_TOKENS / chat_s:.1f} tok/s); multimodal "
        f"request {mm_s:.2f} s")
    log(f"launches on the serving path: {launches} (expected {expect}; "
        f"{gen.prefills} prefills, {gen.decode_steps} decode steps)")
    if errors or len(results) != CHAT_THREADS:
        fail(f"chat requests failed: {errors or results}")
    if launches != expect or launches["K4"] == 0:
        fail(f"kernel launches {launches} != {expect}")
    for i, text in results.items():
        if not text.startswith(CHAT_PROMPTS[i]) \
                or text[len(CHAT_PROMPTS[i]):].count("[") != NEW_TOKENS:
            fail(f"request {i}: stream text {text[:200]!r}")
    vocab = cfg.phi.vocab_size
    if mm_toks.shape != (1, NEW_TOKENS) or mm_toks.min() < 0 \
            or mm_toks.max() >= vocab:
        fail(f"multimodal tokens {mm_toks.shape} {mm_toks.min()} {mm_toks.max()}")
    log(f"multimodal tokens: {mm_toks[0, :16].tolist()} ...")

    # K4 against the packed plain path: one decode step's logits, same cache
    logits, cache = gen.prefill(mm_batch)
    tok = logits.argmax(-1)
    other = cache.clone()
    got = gen.decode(tok, cache).float()
    set_int4_storage(models["int4"], "packed")
    want = gen.decode(tok, other).float()
    set_int4_storage(models["int4"], "pallas")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"decode-step logits, K4 vs packed plain path: max abs err {err:.4e} "
        f"vs max |logit| {scale:.4e} (tol {K4_TOL} x); argmax agree "
        f"{bool((got.argmax(-1) == want.argmax(-1)).all())}")
    if not (torch.isfinite(got).all() and err <= K4_TOL * scale):
        fail(f"K4 decode logits differ from the packed path: {err} vs {scale}")

    del worker, gen, cache, other
    torch.cuda.reset_peak_memory_stats()
    for mode in ("int4", "int8", "bf16"):
        g = Generator(models[mode], max_len=2048, device="cuda")
        for B in (1, CHAT_THREADS):
            batch = chat_batch(np, tokenizer, "<image>\nDescribe the image.",
                               image, B)
            prefill_ms, step_ms, busy = time_decode(torch, g, batch)
            log(f"serve {mode} B={B}: prefill {prefill_ms:.2f} ms "
                f"(sequence {batch['tok_ids'].shape[1]}), decode "
                f"{step_ms:.3f} ms/step, {B * 1e3 / step_ms:.1f} tok/s, device "
                f"busy {busy:.3f} of the decode steps, on {card}")
    log(f"serve peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(three models resident)")
    return launches


def main():
    if not os.path.isdir(os.path.join(HERE, "psalm_tpu_torch")):
        fail("psalm_tpu_torch is not beside chip_smoke.py: run it from the "
             "root of a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), device 0: {kind}")

    log("== build")
    from psalm_tpu_torch.ops import (_build, flash_attention, int4_matvec,
                                     msdeform, swin_attention)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")

    log("== kernels (kernel vs plain PyTorch on the card)")
    records = []
    check_k1(torch, msdeform, records)
    check_k3(torch, swin_attention, records)
    check_k4(torch, int4_matvec, records)
    check_sass(lib_path, _build.find_nvcc())
    check_k5(torch, flash_attention, records)
    check_k2(torch, msdeform, records)
    check_k5_bwd(torch, flash_attention, records)

    log("== small slice (tiny config, f32: card kernels vs CPU plain)")
    check_small_slice(torch, np)
    check_small_tasks(torch, np)

    log("== eval slice (PSALMConfig(), bf16, EvalRunner.infer)")
    path_ms = {}  # K1's and K2's device ms per launch on the paths
    eval_launches = eval_slice(torch, np, card, path_ms)
    torch.cuda.empty_cache()

    log("== serving slice (PSALMConfig(), int4 'pallas' Phi, bf16, ModelWorker)")
    serve_launches = serving_slice(torch, np, card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    log("== eval tasks (PSALMConfig(), bf16, use_flash, EvalRunner.infer)")
    paths = {"eval": eval_launches, "serve": serve_launches}
    paths.update(task_slice(torch, np, card))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    log("== dense pixel decoder (panoptic, attention_mode='dense', use_flash)")
    paths.update(dense_slice(torch, np, card))
    torch.cuda.empty_cache()

    log("== small training (tiny config, f32: card kernels vs CPU plain)")
    paths.update(train_small(torch, np))

    log("== training (PSALMConfig(), deformable, bf16, Trainer.step)")
    paths.update(train_slice(torch, np, card, "deformable", path_ms))
    torch.cuda.empty_cache()

    log("== training, dense pixel decoder (attention_mode='dense', 2 heads)")
    paths.update(train_slice(torch, np, card, "dense", path_ms))

    bad = [m for m in sys.modules if m in ("jax", "flax", "optax")
           or m == "psalm_tpu" or m.startswith("psalm_tpu.")]
    if bad:
        fail(f"JAX or psalm_tpu modules were imported: {bad}")

    kernels = []
    for r in records:
        k = r["kernel"]
        by_path = {path: counts.get(k, 0) for path, counts in paths.items()}
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[k][0],
            "replaces": SOURCES[k][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
            "tol": r["tol"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("int4pack_ms", "kernels_per_call", "limit",
                                 "worst_of_limit") if k in r},
            **({"path_ms_per_launch": {p: v[k] for p, v in path_ms.items()
                                       if k in v}}
               if k in ("K1", "K2") else {})})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
