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
                 K3 backward: each Swin-B stage of a 1024^2 image, with
                    and without the shift mask, bf16 and f32; against
                    autograd through the plain window attention; every
                    element of d qkv and d bias within 2^-7 |want| + 2^-8 M
                    + 1e-5 in bf16 (M: the magnitude of the products whose
                    rounded operand may fall the other way, dP = dO v^T
                    and P) or 1e-5 |want| + 1e-5 M in f32; library: SDPA's
                    backward with a float mask that needs its gradient;
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
               the unquantized bf16 model. The int4 worker also answers one
               /worker_segment panoptic request on a seeded 480x640 JPEG
               over HTTP after a warm-up one (Phi's 2048 rows on the packed
               plain path), with phase 13's word tokenizer and its class
               head scaled by 10 as in phases 12 and 13: error_code 0, at
               least one segment, 6 K1 and 24 K3 launches, no K4; its ms.
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
 12. clis    - the seven eval CLIs (psalm_tpu_torch/eval/*: panoptic,
               semantic, instance, referring, region, gRefCOCO, Cityscapes
               instance) through evaluation(...), on a COCO-format tree
               written from a seed under build/clis: 4 JPEG images of
               480x640, panoptic PNGs of 12 segments an image over COCO's
               133 categories (80 thing, 53 stuff) with their JSON, an
               instance / referring / region JSON with 8 RLE annotations,
               a 12-word sentence and point prompts an image, and a
               150-name semantic list with label PNGs. First the panoptic
               and instance CLIs at the tiny config in f32 (Phi use_flash,
               2 heads of 32), kernels on the card against the plain
               versions on the CPU: panoptic PNGs agree on 99% of pixels,
               ranked instance records item by item as in phase 4. Then
               one PSALMConfig() model in bf16 with use_flash (random
               weights from a seeded torch.Generator) shared by every CLI,
               each after one warm-up image: the counters, zeroed before
               the timed run, must show 6 K1, 24 K3 and 24 K5 (causal)
               launches per image; every metric finite and within [0, 100];
               the artifacts read back (panoptic PNGs + predictions.json
               with the panoptic_official_gt score, instance RLE records,
               the semantic RLE records, the pkl and txt summaries); img/s,
               and the panoptic CLI's ms an image beside EvalRunner.infer's
               p50 on its first image and phase 5's p50.
 13. segment - first SegmentService's three tasks at the tiny config in f32,
               the card against the CPU (each reply's map on 99% of pixels,
               the referring score to 1e-3); then a port controller and a
               port worker on localhost (ModelWorker with one PSALMConfig()
               bf16 model with use_flash, random weights from a seeded
               torch.Generator, WordTokenizer) that registers with the
               controller; the client asks the controller for the worker's
               address and POSTs /worker_segment (a base64 480x640 JPEG)
               once per task after a warm-up request per task: panoptic,
               semantic, referring with a 12-word expression (the class
               head scaled by 10, so that the panoptic reply must hold
               segments). The counters,
               zeroed before the timed requests, must show 6 K1, 24 K3 and
               24 K5 (causal, Phi padded to 2048) per request; every reply
               error_code 0, RLEs decoding to 480x640, unique panoptic ids,
               a finite score; ms per request by task. K5 is held per
               element on a request's Phi layer-0 q, k, v at L = 2048.
 14. davis   - a seeded DAVIS-format tree under build/davis (2 videos of 4
               JPEG frames at 480x854, 3 objects as RLE first-frame
               annotations): the DAVIS CLI (eval_davis.evaluation) at the
               tiny config in f32, the card against the CPU (PNGs agree on
               99% of pixels, the same frames take the memory, some must);
               then on one PSALMConfig() bf16 model with use_flash after a
               warm-up frame: 6 K1, 48 K3 (Swin runs on the frame and on
               the prompt's frame) and 24 K5 causal launches per frame, the
               PNGs read back with the DAVIS palette, every index in {0}
               and the fills; frames/s.
 15. train cli - first three tiny card-vs-CPU checks in f32: the training
               CLI (train.py::main) on a small tree, two tower-training
               steps (PSALM(train_backbone=True), the drop path on fixed
               draws) and QLoRA steps of a tiny Phi, losses (and logits)
               within 1e-3. Then main at the full published width from a
               model directory of seeded random weights (bf16 on disk, f32
               parameters, bf16 compute) on a COCO-format tree under
               build/train_cli (phase 12's writer, with its train2017
               split, and a LLaVA-format chat JSON): panoptic, region,
               referring and mm_conv batches in turn (--data_ratio
               1||1||1||1), batch 1, 2 loader threads, TensorBoard
               scalars, a profiler trace of two steps per call; 4 steps,
               then a second main that resumes at step 4 and goes to 6.
               Every logged loss finite and positive, one checkpoint left
               after each call, the scalars read back equal to
               train_log.jsonl, a trace names K1, K2 and K3; step ms by
               dataset type, launches a step, peak GiB.
 16. train backbone - Trainer.step of PSALM(train_backbone=True) at the
               full published width (deformable, drop path 0-0.3): 1
               warm-up and 3 timed steps, 12 K1, 6 K2, 24 K3 and 24 K3
               backward launches a step; the tower's weights move after
               the second update, its gradients finite; K3's backward held
               per element on the warm-up step's own stage-0 inputs.
 17. qlora   - Phi-1.5 at full width with rank-64 adapters (alpha 16) on
               the int8 base: 3 train_steps under psalm_finetune_optimizer;
               every int8 base tensor bit for bit unchanged, every B
               moved; merge_lora's bf16 Phi gives logits within 5e-2 of
               the largest adapted logit.

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
# swin_attention.window_attention_bwd_limit, M from
# window_attention_bwd_magnitude (M dS = P (|dP| + rowsum(P |dP|)))
K3_BWD_LIMITS = {
    "bfloat16": "2^-7 |want| + 2^-8 M + 1e-5, M = scale M dS |k|, "
                "M dS^T |q scale|, P^T |dO|, sum_w M dS",
    "float32": "1e-5 |want| + 1e-5 M, M = scale M dS |k|, M dS^T |q scale|, "
               "P^T |dO|, sum_w M dS"}
# Swin-B's stages at 1024^2 (feature side, channels, heads), window 12
SWIN_B_STAGES = ((256, 128, 4), (128, 256, 8), (64, 512, 16), (32, 1024, 32))
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
    # the custom VJP of the Swin op (_op_bwd; _op_nomask_bwd :157): jax.vjp
    # of _xla_reference, by recompute
    "K3 backward": ("psalm_tpu_torch/csrc/swin_attention_bwd.cu",
                    "psalm_tpu/ops/swin_attention_pallas.py:137"),
}


def launch_counts():
    """Every kernel's launches since the counters were last zeroed."""
    from psalm_tpu_torch.ops import (flash_attention, int4_matvec, msdeform,
                                     swin_attention)
    fa = flash_attention
    return {"K1": msdeform.LAUNCHES, "K2": msdeform.BWD_LAUNCHES,
            "K3": swin_attention.LAUNCHES, "K4": int4_matvec.LAUNCHES,
            "K3 backward": swin_attention.BWD_LAUNCHES,
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
    swin_attention.LAUNCHES = swin_attention.BWD_LAUNCHES = 0
    int4_matvec.LAUNCHES = 0
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
    for stage, (res, C, h) in enumerate(SWIN_B_STAGES):
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


def check_k3_bwd(torch, swin_attention, records, stages=SWIN_B_STAGES):
    """K3's backward at each Swin-B stage of a 1024^2 image, with and
    without the shift mask, bf16 and f32: every element of d qkv and d bias
    within ``window_attention_bwd_limit`` of the twin (autograd through
    ``window_attention_ref``, its bf16 products summed in f32)."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _check_k3_bwd(torch, swin_attention, records, stages)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def hold_k3_bwd(torch, swin_attention, name, args, dout):
    """d qkv and d bias of the kernel against the twin's on ``args`` (qkv,
    bias, mask, heads, scale); returns (max |err| of d qkv, its largest
    limit, the worst share of the limit by output)."""
    got = swin_attention.window_attention_bwd(*args, dout)
    want = swin_attention.window_attention_bwd_ref(*args, dout)
    mags = swin_attention.window_attention_bwd_magnitude(*args, dout)
    torch.cuda.synchronize()
    formula = K3_BWD_LIMITS[dtype_name(args[0].dtype)]
    held = {}
    for what, a, b, mag in zip(("d_qkv", "d_bias"), got, want, mags):
        limit = swin_attention.window_attention_bwd_limit(b, mag,
                                                          args[0].dtype)
        held[what] = hold(f"{name} {what}", a, b, limit, formula)
    return held["d_qkv"][0], held["d_qkv"][1], {k: v[2] for k, v in
                                                held.items()}


def _check_k3_bwd(torch, swin_attention, records, stages):
    import torch.nn.functional as F
    from psalm_tpu_torch.models.swin import shift_attn_mask
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    ws, N = 12, 144
    for stage, (res, C, h) in enumerate(stages):
        Hp = -(-res // ws) * ws
        nW = (Hp // ws) ** 2
        hd = C // h
        qkv32 = torch.randn(nW, N, 3 * C, generator=g, device=dev)
        dout32 = torch.randn(nW, N, C, generator=g, device=dev)
        bias = torch.randn(h, N, N, generator=g, device=dev)
        mask = torch.from_numpy(shift_attn_mask(Hp, Hp, ws, ws // 2)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dtype).contiguous()
            dout = dout32.to(dtype).contiguous()
            for m in (None, mask):
                args = (qkv, bias, m, h, hd ** -0.5)
                name = (f"K3 backward window_attention_bwd {dtype_name(dtype)}"
                        f" stage{stage} Bn={nW} C={C} h={h} "
                        f"{'shift-mask' if m is not None else 'no-mask'}")
                err, tol, worst = hold_k3_bwd(torch, swin_attention, name,
                                              args, dout)
                # the library: SDPA's backward with a float mask that needs
                # its gradient (bias + shift mask, one [N, N] per window)
                q, k, v = (t.reshape(nW, N, h, hd).transpose(1, 2)
                           .detach().clone().requires_grad_()
                           for t in qkv.split(C, dim=-1))
                am = (bias[None] if m is None else bias[None] + m[:, None])
                am = am.expand(nW, h, N, N).to(dtype).contiguous() \
                    .requires_grad_()
                ref_out = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                         scale=hd ** -0.5)
                do4 = dout.reshape(nW, N, h, hd).transpose(1, 2)

                def library():
                    torch.autograd.grad(ref_out, (q, k, v, am), do4,
                                        retain_graph=True)

                elt = qkv.element_size()
                # read qkv, dO, bias (and mask), write d qkv and d bias; five
                # [N, N] x hd products a (window, head)
                nbytes = (2 * qkv.numel() + dout.numel()) * elt \
                    + 2 * bias.numel() * 4 \
                    + (m.numel() * 4 if m is not None else 0)
                flops = 10 * nW * h * N * N * hd
                record(records, "K3 backward", name, err, tol,
                       lambda: swin_attention.window_attention_bwd(*args, dout),
                       lambda: swin_attention.window_attention_bwd_ref(*args,
                                                                       dout),
                       library, bound(nbytes, flops, dtype_name(dtype)))
                records[-1].update(limit=K3_BWD_LIMITS[dtype_name(dtype)],
                                   worst_of_limit=worst)
                del ref_out, q, k, v, am


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
        hold_k5(flash_attention, records, q, k, v, causal)


def hold_k5(flash_attention, records, q, k, v, causal, what=""):
    """K5 on q, k, v [B, h, L, hd] against its plain version, per element
    (``k5_limit``), timed beside the plain version and SDPA."""
    import torch.nn.functional as F
    B, h, L, hd = q.shape
    kw = dict(causal=causal, sm_scale=hd ** -0.5)
    got = flash_attention.flash_attention(q, k, v, **kw).float()
    want = flash_attention.flash_attention_ref(q, k, v, **kw).float()
    kernel = "K5 causal" if causal else "K5 non-causal"
    name = (f"{kernel} flash_attention {dtype_name(q.dtype)} B={B} h={h} "
            f"L={L} hd={hd}{what}")
    limit, formula = k5_limit(flash_attention, q, k, v, want, **kw)
    diff = (got - want).abs()
    worst = (diff / limit).max().item()
    log(f"  {name}: |out| max {want.abs().max().item():.4e}, rms "
        f"{want.square().mean().sqrt().item():.4e}; largest |got - want| "
        f"is {worst:.4f} of its limit {formula}")
    if not worst <= 1.0:
        fail(f"{name}: |got - want| exceeds {formula} by {worst}x")
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read, out written
    flops = 4 * B * h * L * L * hd // (2 if causal else 1)
    record(records, kernel, name, diff.max().item(), limit.max().item(),
           lambda: flash_attention.flash_attention(q, k, v, **kw),
           lambda: flash_attention.flash_attention_ref(q, k, v, **kw),
           lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=causal, scale=hd ** -0.5),
           bound(nbytes, flops, dtype_name(q.dtype)))
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


def eval_slice(torch, np, card, path_ms, timings):
    """Phase 5; returns the kernels' launches in the timed run, keeps K1's
    device ms per launch in ``path_ms`` and the p50 in ``timings``."""
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
    timings["eval p50 ms"] = p50 * 1e3
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


class FixedDraws:
    """Point and drop-path draws that are the same numbers on every device:
    one U[0, 1) array per shape (numpy, seed 11), moved to the generator's
    device."""

    def __init__(self, np, torch):
        self.np, self.torch, self.draws = np, torch, {}

    def __call__(self, generator, shape):
        shape = tuple(shape)
        if shape not in self.draws:
            rng = self.np.random.default_rng([11, *shape])
            self.draws[shape] = rng.uniform(size=shape).astype(self.np.float32)
        return self.torch.from_numpy(self.draws[shape]).to(generator.device)


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
        draws = FixedDraws(np, torch)
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
                              uniform_fn=draws)
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
    """Phase 6; returns the kernels' launches on the chat path and on the
    int4 worker's segment request."""
    import dataclasses
    from psalm_tpu_torch import PSALMConfig
    from psalm_tpu_torch.models.builder import model_from_state_dict
    from psalm_tpu_torch.models.generation import Generator
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.serve.model_worker import ModelWorker, make_handler
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

    # the worker's /worker_segment route on the int4 model: Phi's rows of
    # the segment prompt take the packed plain path (K4 takes rows <= 16).
    # Its segmenter takes the word tokenizer, as phase 13's does: the
    # character tokenizer spreads each of the 134 class names over many
    # tokens, and no query passed the 0.8 threshold with it.
    worker.tokenizer = WordTokenizer(cfg.phi.vocab_size)
    with torch.no_grad():  # so that panoptic queries pass the 0.8 threshold
        models["int4"].predictor.CLASS_proj.layers[-1].weight.mul_(10.0)
    srv, url = serve_http(make_handler(worker))
    request = {"image": jpeg_b64(np, SEGMENT_HW, 6), "task": "panoptic"}
    try:
        post_json(url + "/worker_segment", request)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        reply = post_json(url + "/worker_segment", request)
        seg_ms = (time.perf_counter() - t0) * 1e3
        seg_counts = launch_counts()
    finally:
        srv.shutdown()
        srv.server_close()
    seg_expect = expected(K1=cfg.pixel_decoder.transformer_enc_layers,
                          K3=sum(cfg.swin.depths))
    what = check_segment_reply(np, "panoptic", reply, SEGMENT_HW)
    if not reply["segments"]:
        fail("int4 worker segment panoptic: the reply holds no segment")
    log(f"int4 worker /worker_segment panoptic on a {SEGMENT_HW[0]}x"
        f"{SEGMENT_HW[1]} JPEG: {seg_ms:.1f} ms (one request after a warm-up"
        f" one; Phi's sequence of 2048 on the packed plain path) on {card}; "
        f"{what}; launches {seg_counts} (expected {seg_expect})")
    if seg_counts != seg_expect:
        fail(f"int4 worker segment launches {seg_counts} != {seg_expect}")

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
    return {"serve": launches, "serve/segment": seg_counts}


# -- phase 12: the eval CLIs ------------------------------------------------

CLI_IMAGES = 4          # images of the tree: one warm-up, then all timed
CLI_HW = (480, 640)     # bench.py's original geometry
CLI_SEGMENTS = 12       # panoptic segments (and semantic regions) an image
CLI_ANNS = 8            # instance / referring / region annotations an image
CLI_SENTENCE = 12       # words (tokens) of a referring sentence
SEM_CLASSES = 150       # names of the semantic list (ADE-150's count)
# COCO panoptic's 53 stuff categories (panoptic_coco_categories.json)
COCO_STUFF = (
    (92, "banner"), (93, "blanket"), (95, "bridge"), (100, "cardboard"),
    (107, "counter"), (109, "curtain"), (112, "door-stuff"),
    (118, "floor-wood"), (119, "flower"), (122, "fruit"), (125, "gravel"),
    (128, "house"), (130, "light"), (133, "mirror-stuff"), (138, "net"),
    (141, "pillow"), (144, "platform"), (145, "playingfield"),
    (147, "railroad"), (148, "river"), (149, "road"), (151, "roof"),
    (154, "sand"), (155, "sea"), (156, "shelf"), (159, "snow"),
    (161, "stairs"), (166, "tent"), (168, "towel"), (171, "wall-brick"),
    (175, "wall-stone"), (176, "wall-tile"), (177, "wall-wood"),
    (178, "water-other"), (180, "window-blind"), (181, "window-other"),
    (184, "tree-merged"), (185, "fence-merged"), (186, "ceiling-merged"),
    (187, "sky-other-merged"), (188, "cabinet-merged"),
    (189, "table-merged"), (190, "floor-other-merged"),
    (191, "pavement-merged"), (192, "mountain-merged"),
    (193, "grass-merged"), (194, "dirt-merged"), (195, "paper-merged"),
    (196, "food-other-merged"), (197, "building-other-merged"),
    (198, "rock-merged"), (199, "wall-other-merged"), (200, "rug-merged"))
SENTENCE_WORDS = ("the", "person", "on", "left", "right", "holding", "a",
                  "red", "blue", "umbrella", "near", "car", "behind", "tall",
                  "small", "dog", "table", "in", "front", "of", "white")
METRIC_KEYS_NOT_PERCENT = ("n", "thr", "type", "images_per_sec")


class WordTokenizer:
    """A deterministic word tokenizer for the CLIs (no tokenizer files on the
    card's machine): one id per space-separated word, 3 + crc32 % (vocab -
    3), so a class name or a sentence word is one token or a few, as a BPE
    vocabulary gives them."""

    def __init__(self, vocab):
        self.vocab = vocab

    def encode(self, text, add_special_tokens=False):
        import zlib
        return [3 + zlib.crc32(w.encode()) % (self.vocab - 3)
                for w in text.replace("\n", " \n ").split(" ") if w]


def write_cli_tree(np, root, n_images, hw, n_thing, n_stuff, segments, anns,
                   sem_classes, seed):
    """A COCO-format tree from ``seed``: val2017/ JPEGs; panoptic_val2017/
    id2rgb PNGs of ``segments`` Voronoi cells (and a void strip) with their
    annotations/panoptic_val2017.json over ``n_thing`` COCO thing and
    ``n_stuff`` stuff categories; instance.json with ``anns`` RLE
    rectangles an image, a referring sentence and a point prompt each; and
    a semantic list with label PNGs of ``sem_classes`` classes (255 void).
    Returns the paths the CLIs take."""
    from PIL import Image
    from psalm_tpu_torch.data import coco_rle
    from psalm_tpu_torch.data.datasets import COCO_CLASS_IDS, COCO_CLASS_NAMES
    rng = np.random.default_rng(seed)
    H, W = hw
    paths = {"root": os.path.join(root, "coco"),
             "instance_json": os.path.join(root, "instance.json"),
             "sem_list": os.path.join(root, "semantic_list.txt"),
             "sem_labels": os.path.join(root, "semantic_labels"),
             "sem_names": os.path.join(root, "semantic_names.txt")}
    images = os.path.join(paths["root"], "val2017")
    paths["images"] = paths["sem_images"] = images
    pan_dir = os.path.join(paths["root"], "panoptic_val2017")
    for d in (images, pan_dir, os.path.join(paths["root"], "annotations"),
              paths["sem_labels"]):
        os.makedirs(d, exist_ok=True)
    cats = ([{"id": i, "name": n, "isthing": 1} for i, n in
             zip(COCO_CLASS_IDS[:n_thing], COCO_CLASS_NAMES[:n_thing])]
            + [{"id": i, "name": n, "isthing": 0}
               for i, n in COCO_STUFF[:n_stuff]])
    yy, xx = np.mgrid[:H, :W]
    pan_anns, inst, sem_lines = [], [], []
    for i in range(n_images):
        name = f"{i:012d}"
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            os.path.join(images, name + ".jpg"))
        seeds = rng.uniform((0, 0), (H, W), (segments, 2))
        cell = ((yy[..., None] - seeds[:, 0]) ** 2
                + (xx[..., None] - seeds[:, 1]) ** 2).argmin(-1)
        void = xx < max(W // 80, 1)
        seg_ids = rng.choice(np.arange(1, 2 ** 16), segments, replace=False)
        pan = np.where(void, 0, seg_ids[cell]).astype(np.uint32)
        Image.fromarray(coco_rle.id2rgb(pan)).save(
            os.path.join(pan_dir, name + ".png"))
        pan_anns.append({"image_id": i, "file_name": name + ".png",
                         "segments_info": [
                             {"id": int(s), "iscrowd": 0,
                              "category_id": cats[int(c)]["id"]}
                             for s, c in zip(seg_ids, rng.integers(
                                 0, len(cats), segments))]})
        records = []
        for _ in range(anns):
            h, w = rng.integers(H // 8, H // 2), rng.integers(W // 8, W // 2)
            y0, x0 = rng.integers(0, H - h), rng.integers(0, W - w)
            mask = np.zeros((H, W), np.uint8)
            mask[y0:y0 + h, x0:x0 + w] = 1
            point = np.zeros((H, W), np.uint8)
            point[y0 + h // 2, x0 + w // 2] = 1
            rle, prle = coco_rle.encode(mask), coco_rle.encode(point)
            records.append({
                "category_id": COCO_CLASS_IDS[int(rng.integers(n_thing))],
                "bbox": [int(x0), int(y0), int(w), int(h)], "iscrowd": 0,
                "segmentation": dict(rle, counts=rle["counts"].decode()),
                "point_visual_prompt_mask": dict(
                    prle, counts=prle["counts"].decode())})
        sentence = " ".join(rng.choice(SENTENCE_WORDS, CLI_SENTENCE))
        inst.append({"image": name + ".jpg", "new_img_id": i,
                     "image_info": {"height": H, "width": W,
                                    "file_name": name + ".jpg"},
                     "instruction": [{"sent": sentence}], "anns": records})
        label = rng.integers(0, sem_classes, segments)[cell].astype(np.uint8)
        label[void] = 255
        Image.fromarray(label).save(
            os.path.join(paths["sem_labels"], name + ".png"))
        sem_lines.append(f"{name}.jpg {name}.png")
    with open(os.path.join(paths["root"],
                           "annotations/panoptic_val2017.json"), "w") as f:
        json.dump({"annotations": pan_anns, "categories": cats,
                   "images": [{"id": i, "file_name": f"{i:012d}.jpg",
                               "height": H, "width": W}
                              for i in range(n_images)]}, f)
    with open(paths["instance_json"], "w") as f:
        json.dump(inst, f)
    with open(paths["sem_list"], "w") as f:
        f.write("\n".join(sem_lines))
    with open(paths["sem_names"], "w") as f:
        f.write("\n".join(f"ade{k:03d} stuff" for k in range(sem_classes)))
    return paths


def write_davis_tree(np, root, videos, frames, hw, objects, seed, fills=None):
    """A DAVIS-2017-format tree from ``seed``: JPEGImages/480p/<video>/
    <frame>.jpg and davis_val_psalm.json, one record per frame naming the
    video's first frame and its ``objects`` first-frame annotations
    (ellipses as RLEs, ``category_id`` = the object's fill, 1, 2, ... or
    ``fills``). Returns (root, json path)."""
    from PIL import Image
    from psalm_tpu_torch.data import coco_rle
    rng = np.random.default_rng(seed)
    H, W = hw
    fills = list(fills or range(1, objects + 1))
    yy, xx = np.mgrid[:H, :W]
    records = []
    for v in range(videos):
        video = f"video{v:02d}"
        vdir = os.path.join(root, "JPEGImages", "480p", video)
        os.makedirs(vdir, exist_ok=True)
        for f in range(frames):
            Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                            ).save(os.path.join(vdir, f"{f:05d}.jpg"))
        anns = []
        for fill in fills:
            cy, cx = rng.uniform(0.2, 0.8, 2) * (H, W)
            ry, rx = rng.uniform(0.08, 0.25, 2) * (H, W)
            m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
            rle = coco_rle.encode(m.astype(np.uint8))
            anns.append({"category_id": int(fill),
                         "segmentation": dict(rle,
                                              counts=rle["counts"].decode())})
        first = f"JPEGImages/480p/{video}/00000.jpg"
        records += [{"image": f"JPEGImages/480p/{video}/{f:05d}.jpg",
                     "first_frame_image": first, "first_frame_anns": anns}
                    for f in range(frames)]
    path = os.path.join(root, "davis_val_psalm.json")
    with open(path, "w") as fh:
        json.dump(records, fh)
    return root, path


# each CLI: (module, task, the flags beside the common ones)
CLIS = (
    ("panoptic_segmentation", "panoptic",
     lambda p: dict(json_path=p["root"], image_folder=None,
                    eval_batch_size=1)),
    ("semantic_segmentation", "semantic",
     lambda p: dict(list_path=p["sem_list"], image_folder=p["sem_images"],
                    label_folder=p["sem_labels"], class_names=p["sem_names"],
                    num_class=0, ignore_label=255)),
    ("instance_segmentation", "instance",
     lambda p: dict(json_path=p["instance_json"], image_folder=p["images"],
                    eval_batch_size=1)),
    ("referring_segmentation", "referring",
     lambda p: dict(json_path=p["instance_json"], image_folder=p["images"],
                    eval_batch_size=1)),
    ("region_segmentation", "region",
     lambda p: dict(json_path=p["instance_json"], image_folder=p["images"],
                    eval_batch_size=1,
                    region_mask_type="point_visual_prompt_mask")),
    ("eval_grefcoco", "referring",
     lambda p: dict(json_path=p["instance_json"], image_folder=p["images"],
                    thr=0.6)),
    ("cityscapes_instance", "instance",
     lambda p: dict(json_path=p["instance_json"], image_folder=p["images"])),
)


def run_cli(module, task, flags, paths, model, cfg, tokenizer, out_dir,
            limit):
    """One CLI's ``evaluation`` on the tree, its printout kept out of the
    log: (results, wall seconds)."""
    import argparse
    import contextlib
    import importlib
    import io
    from psalm_tpu_torch import SegTask
    args = argparse.Namespace(model_path="", model_max_length=2048,
                              seq_bucket=128, limit=limit,
                              **flags(paths))
    if module != "cityscapes_instance":  # the one CLI without the flag
        args.output_dir = out_dir
    evaluation = importlib.import_module(
        f"psalm_tpu_torch.eval.{module}").evaluation
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = evaluation(args, cfg=cfg.replace(seg_task=SegTask(task)),
                         tokenizer=tokenizer, model=model)
    return res, time.perf_counter() - t0


def check_metrics(np, module, res):
    """Every metric finite, the percentages in [0, 100]."""
    def walk(x, key=""):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, k)
        elif key not in METRIC_KEYS_NOT_PERCENT:
            if not (np.isfinite(x) and 0 <= x <= 100):
                fail(f"{module}: metric {key} = {x}")
    walk(res)
    if not res.get("images_per_sec", 0) > 0:
        fail(f"{module}: images_per_sec {res.get('images_per_sec')}")


def read_artifacts(np, module, out_dir, n, hw, Q):
    """Read a CLI's artifact files back: shapes, ids and scores."""
    import pickle
    import cv2
    from psalm_tpu_torch.data import coco_rle
    if module == "panoptic_segmentation":
        pred_dir = os.path.join(out_dir, "panoptic_preds")
        with open(os.path.join(pred_dir, "predictions.json")) as f:
            anns = json.load(f)["annotations"]
        if len(anns) != n:
            fail(f"{module}: {len(anns)} predictions for {n} images")
        for ann in anns:
            png = cv2.imread(os.path.join(pred_dir, ann["file_name"]))
            if png is None or png.shape[:2] != hw:
                fail(f"{module}: unreadable PNG {ann['file_name']}")
            ids = set(np.unique(coco_rle.rgb2id(png[..., ::-1])).tolist())
            if ids - {0} != {s["id"] for s in ann["segments_info"]}:
                fail(f"{module}: PNG ids {ids} != declared segments")
        return f"{n} PNGs + predictions.json, " \
               f"{sum(len(a['segments_info']) for a in anns)} segments"
    if module == "instance_segmentation":
        with open(os.path.join(out_dir, "coco_instances_results.json")) as f:
            recs = json.load(f)
        if len(recs) != n * Q:
            fail(f"{module}: {len(recs)} records for {n} images x {Q}")
        for r in recs:
            m = coco_rle.decode(r["segmentation"])
            if m.shape != hw or not 0 <= r["score"] <= 1:
                fail(f"{module}: record {m.shape}, score {r['score']}")
        return f"{len(recs)} RLE records"
    if module == "semantic_segmentation":
        with open(os.path.join(out_dir, "sem_seg_predictions.json")) as f:
            recs = json.load(f)
        if len({r["file_name"] for r in recs}) != n or any(
                coco_rle.decode(r["segmentation"]).shape != hw for r in recs):
            fail(f"{module}: sem_seg_predictions.json does not cover {n} "
                 "images at the original size")
        return f"{len(recs)} per-class RLE records"
    if module == "cityscapes_instance":
        return "no artifacts (the CLI writes none)"
    pkls = [f for f in os.listdir(out_dir) if f.endswith(".pkl")]
    txts = [f for f in os.listdir(out_dir) if f.endswith(".txt")]
    if len(pkls) != 1 or len(txts) != 1:
        fail(f"{module}: artifacts {sorted(os.listdir(out_dir))}")
    with open(os.path.join(out_dir, pkls[0]), "rb") as f:
        saved = pickle.load(f)
    with open(os.path.join(out_dir, txts[0])) as f:
        txt = f.read()
    if len(saved) != n or not txt.startswith("benchmark: ") or any(
            coco_rle.decode(m).shape != hw for s in saved
            for m in s["pred"] + s["gt"]):
        fail(f"{module}: {pkls[0]} / {txts[0]} do not read back")
    return f"{pkls[0]} ({sum(len(s['pred']) for s in saved)} masks), {txts[0]}"


def clis_slice(torch, np, card, timings, records):
    """Phase 12; returns each CLI's launches in its timed run. Phi's
    attention inputs are kept at each sequence length the CLIs give it, and
    K5 is held against its plain version on them."""
    import shutil
    from psalm_tpu_torch import PSALMConfig
    from psalm_tpu_torch.data.datasets import DataConfig, PanopticDataset, collate
    from psalm_tpu_torch.eval.runner import EvalRunner, bucket_for_sizes
    from psalm_tpu_torch.models import phi
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.ops import flash_attention
    root = os.path.join(HERE, "build", "clis")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_cli_tree(np, root, CLI_IMAGES, CLI_HW, n_thing=80,
                           n_stuff=53, segments=CLI_SEGMENTS, anns=CLI_ANNS,
                           sem_classes=SEM_CLASSES, seed=12)
    log(f"tree: {CLI_IMAGES} images of {CLI_HW[0]}x{CLI_HW[1]}, 133 "
        f"panoptic categories, {CLI_SEGMENTS} segments, {CLI_ANNS} RLE "
        f"annotations and a {CLI_SENTENCE}-word sentence an image, "
        f"{SEM_CLASSES} semantic names; written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = PSALMConfig(compute_dtype="bfloat16")
    model = PSALM(cfg, dtype=torch.bfloat16, device="cuda", use_flash=True)
    init_weights_(model, torch.Generator(device="cuda").manual_seed(12))
    model.to(torch.bfloat16)
    tokenizer = WordTokenizer(cfg.phi.vocab_size)
    Q = cfg.mask_decoder.num_queries
    per_image = expected(K1=cfg.pixel_decoder.transformer_enc_layers,
                         K3=sum(cfg.swin.depths),
                         K5_causal=cfg.phi.num_layers)
    # the runner alone on the panoptic CLI's first image, with this model
    ds = PanopticDataset(paths["root"], tokenizer, DataConfig(
        image_size=cfg.image_size, num_image_tokens=(cfg.image_size // 64) ** 2,
        num_seg_queries=Q, pad_len=2048), is_train=False)
    t0 = time.perf_counter()
    for i in range(CLI_IMAGES):
        batch = collate([ds[i]], seq_bucket=128)
    data_ms = (time.perf_counter() - t0) / CLI_IMAGES * 1e3
    batch = collate([ds[0]], seq_bucket=128)
    runner = EvalRunner(model, cfg, num_class_names=len(ds.coco_class_name),
                        is_thing=ds.is_thing + [False],
                        bucket_hw=bucket_for_sizes(ds.image_sizes))
    times, _, _, _ = timed_images(torch, runner, batch, 2, 3)
    infer_p50 = sorted(times)[1] * 1e3
    launches = {}
    seen = {}    # Phi's sequence length -> its K5 launches in a timed run
    inputs = {}  # sequence length -> the (q, k, v) of its first launch

    def watched(q, k, v, **kw):
        seen[q.shape[2]] = seen.get(q.shape[2], 0) + 1
        if q.shape[2] not in inputs:
            inputs[q.shape[2]] = (q.clone(), k.clone(), v.clone())
        return kernel(q, k, v, **kw)

    kernel, phi.flash_attention = phi.flash_attention, watched
    for module, task, flags in CLIS:
        out = os.path.join(root, "out", module)
        run_cli(module, task, flags, paths, model, cfg, tokenizer,
                os.path.join(root, "warmup", module), 1)
        torch.cuda.synchronize()
        zero_counts()
        seen.clear()
        res, wall = run_cli(module, task, flags, paths, model, cfg, tokenizer,
                            out, CLI_IMAGES)
        counts = launch_counts()
        log(f"{module}: K5 causal launches by Phi's sequence length "
            f"{dict(sorted(seen.items()))}")
        expect = {k: v * (CLI_IMAGES) for k, v in per_image.items()}
        if counts != expect:
            fail(f"{module}: kernel launches {counts} != {expect}")
        check_metrics(np, module, res)
        if module == "panoptic_segmentation" and \
                "panoptic_official_gt" not in res:
            fail("panoptic: no panoptic_official_gt score")
        what = read_artifacts(np, module, out, CLI_IMAGES, CLI_HW, Q)
        headline = {k: v for k, v in res.items() if k != "images_per_sec"}
        log(f"{module}: {(CLI_IMAGES) / wall:.3f} img/s "
            f"({CLI_IMAGES} images, {wall / CLI_IMAGES * 1e3:.1f} "
            f"ms an image; the CLI's own figure "
            f"{res['images_per_sec']:.3f} img/s) on {card}; launches per "
            f"image as expected; artifacts: {what}; {json.dumps(headline)}")
        launches[f"clis/{module}"] = counts
        if module == "panoptic_segmentation":
            cli_ms = wall / (CLI_IMAGES) * 1e3
            log(f"panoptic CLI {cli_ms:.1f} ms an image against "
                f"EvalRunner.infer p50 {infer_p50:.1f} ms on its first "
                f"image with this model (use_flash) and phase 5's p50 "
                f"{timings['eval p50 ms']:.1f} ms (no use_flash): "
                f"{cli_ms - infer_p50:.1f} ms an image of data layer, "
                f"metrics and artifacts that the Prefetcher does not hide; "
                f"the dataset read and collate alone take {data_ms:.1f} ms "
                f"an image (on the Prefetcher's thread in the CLI)")
    phi.flash_attention = kernel
    log("K5 causal on the CLIs' own attention inputs (Phi layer 0), at each "
        "sequence length they gave it")
    for L in sorted(inputs):
        hold_k5(flash_attention, records, *inputs[L], True,
                " (phase 12 activations)")
    del model, inputs
    gc.collect()
    return launches


def check_small_clis(torch, np):
    """Tiny config (Phi use_flash, 2 heads of 32) in f32: the panoptic and
    instance CLIs with the kernels on the card against the same CLIs with
    the plain versions on the CPU, same weights, same tree. The class head
    is scaled so that some queries pass the panoptic 0.8 threshold: the
    CPU's PNGs must hold segments, or the comparison would see void alone."""
    import shutil
    from psalm_tpu_torch.data import coco_rle
    import cv2
    cfg = small_cfg()
    root = os.path.join(HERE, "build", "clis_small")
    shutil.rmtree(root, ignore_errors=True)
    paths = write_cli_tree(np, root, 3, (48, 64), n_thing=3, n_stuff=2,
                           segments=4, anns=2, sem_classes=4, seed=13)
    tokenizer = WordTokenizer(cfg.phi.vocab_size)
    cpu, gpu = small_model(torch, cfg, 7)
    for module, task, flags in CLIS[:1] + CLIS[2:3]:
        res = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            res[dev] = run_cli(module, task, flags, paths, model, cfg,
                               tokenizer, os.path.join(root, dev, module),
                               3)[0]
            res[dev].pop("images_per_sec")
        if module == "panoptic_segmentation":
            pred = [os.path.join(root, dev, module, "panoptic_preds")
                    for dev in ("cpu", "cuda")]
            names = sorted(f for f in os.listdir(pred[0]) if f.endswith(".png"))
            agree = [np.mean(coco_rle.rgb2id(cv2.imread(os.path.join(
                pred[0], f))) == coco_rle.rgb2id(cv2.imread(os.path.join(
                    pred[1], f)))) for f in names]
            with open(os.path.join(pred[0], "predictions.json")) as f:
                segments = sum(len(a["segments_info"])
                               for a in json.load(f)["annotations"])
            if not segments:
                fail(f"small clis {module}: the CPU's PNGs hold no segment")
            if len(names) != 3 or min(agree) < 0.99:
                fail(f"small clis {module}: PNG agreement {agree}")
            # the semantic maps: the same decisions give the same metrics
            sem = [res[dev]["semantic"] for dev in ("cpu", "cuda")]
            if sem[0].keys() != sem[1].keys() or any(
                    abs(sem[1][k] - sem[0][k]) > 1e-6 for k in sem[0]):
                fail(f"small clis {module}: semantic metrics {sem[1]} != "
                     f"the CPU's {sem[0]} (limit 1e-6)")
            what = (f"{segments} segments on the CPU; panoptic PNGs agree on "
                    f"{min(agree):.6f} at worst; semantic metrics within 1e-6")
        else:
            recs = []
            for dev in ("cpu", "cuda"):
                with open(os.path.join(root, dev, module,
                                       "coco_instances_results.json")) as f:
                    recs.append(json.load(f))
            want, got = recs
            Q = cfg.mask_decoder.num_queries
            if not len(got) == len(want) == 3 * Q:
                fail(f"small clis {module}: {len(got)} vs {len(want)} records")
            for b in range(3):
                ranked = {
                    "scores": [np.asarray([r["score"] for r in
                                           rs[b * Q:(b + 1) * Q]])
                               for rs in (got, want)],
                    "classes": [np.asarray([r["category_id"] for r in
                                            rs[b * Q:(b + 1) * Q]])
                                for rs in (got, want)],
                    "masks": [np.stack([coco_rle.decode(r["segmentation"])
                                        for r in rs[b * Q:(b + 1) * Q]])
                              for rs in (got, want)]}
                ranked_agree(np, {k: [v[0]] for k, v in ranked.items()},
                             {k: [v[1]] for k, v in ranked.items()},
                             f"clis {module} image {b}")
            what = "ranked items agree"
        log(f"  {module}: {what}; metrics cpu {json.dumps(res['cpu'])} / "
            f"cuda {json.dumps(res['cuda'])}")


# -- phases 13 and 14: the segment service and the DAVIS CLI ----------------

SEGMENT_HW = (480, 640)  # bench.py's original geometry
SEGMENT_WORDS = 12       # words of the referring expression
DAVIS_VIDEOS, DAVIS_FRAMES = 2, 4
DAVIS_HW = (480, 854)    # DAVIS-2017's 480p frames
DAVIS_OBJECTS = 3
SMALL_AGREE = 0.99       # pixels of a tiny map that the card and CPU share


def jpeg_b64(np, hw, seed):
    """A seeded random JPEG of ``hw``, base64 as a client sends it."""
    import base64
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, hw + (3,), dtype=np.uint8)).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def post_json(url, payload, timeout=600):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def serve_http(handler):
    """A ThreadingHTTPServer on a free localhost port, serving on a daemon
    thread: (server, its URL). The handler may be set later, before the
    first request."""
    from http.server import ThreadingHTTPServer
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


def check_segment_reply(np, task, reply, hw):
    """A /worker_segment reply: error_code 0, the image's size, every RLE
    decoding to it, unique panoptic ids, a finite referring score."""
    from psalm_tpu_torch.data import coco_rle
    if reply.get("error_code") != 0:
        fail(f"segment {task}: {reply}")
    if (reply["height"], reply["width"]) != hw:
        fail(f"segment {task}: reply size {reply['height']}x{reply['width']}")
    if task == "panoptic":
        rles = [s["rle"] for s in reply["segments"]]
        ids = [s["id"] for s in reply["segments"]]
        if len(set(ids)) != len(ids):
            fail(f"segment panoptic: repeated ids {ids}")
        what = f"{len(ids)} segments"
    elif task == "semantic":
        rles = [c["rle"] for c in reply["classes"]]
        what = f"{len(rles)} classes"
    else:
        rles = [reply["rle"]]
        if not (np.isfinite(reply["score"]) and 0 <= reply["score"] <= 1):
            fail(f"segment referring: score {reply['score']}")
        what = f"score {reply['score']:.4f}"
    for rle in rles:
        if coco_rle.decode(rle).shape != hw:
            fail(f"segment {task}: an RLE of {rle['size']}")
    return what + f", {sum(coco_rle.area(r) for r in rles)} pixels"


def _reply_map(np, task, reply, hw):
    """A reply as one map: panoptic ids, semantic classes, the referring
    mask (-1 where no RLE covers a pixel)."""
    from psalm_tpu_torch.data import coco_rle
    out = np.full(hw, -1, np.int64)
    if task == "referring":
        out[coco_rle.decode(reply["rle"]).astype(bool)] = 1
        return out
    for item in reply["segments" if task == "panoptic" else "classes"]:
        out[coco_rle.decode(item["rle"]).astype(bool)] = item.get(
            "id", item["category_id"])
    return out


def small_model(torch, cfg, seed):
    """The tiny checks' CPU model: random weights, sampling offsets beyond
    the init's +-4 px, the class head scaled so that panoptic queries pass
    the 0.8 threshold; and its copy on the card."""
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    cpu = init_weights_(PSALM(cfg, device="cpu", use_flash=True),
                        torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in cpu.pixel_decoder.transformer.encoder.layers:
            layer.self_attn.sampling_offsets.bias.mul_(3.0)
        cpu.predictor.CLASS_proj.layers[-1].weight.mul_(10.0)
    gpu = PSALM(cfg, device="cuda", use_flash=True)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def small_cfg():
    import dataclasses
    from psalm_tpu_torch import tiny_test_config
    base = tiny_test_config()
    return base.replace(phi=dataclasses.replace(base.phi, num_heads=2))


def check_small_segment(torch, np):
    """Tiny config (Phi use_flash, 2 heads of 32) in f32: SegmentService's
    three tasks with the kernels on the card against the plain versions on
    the CPU, same weights, on a seeded 97x131 image: each reply's map
    agrees on 99% of pixels, the referring score to 1e-3."""
    from psalm_tpu_torch.serve.segmentation import SegmentService
    cfg = small_cfg()
    tokenizer = WordTokenizer(cfg.phi.vocab_size)
    hw = (97, 131)
    image = np.random.default_rng(13).integers(0, 256, hw + (3,),
                                               dtype=np.uint8)
    names = [f"class {i}" for i in range(cfg.num_classes)] + ["background"]
    services = {dev: SegmentService(model, tokenizer, cfg, class_names=names,
                                    is_thing=[True, True, True, False, False],
                                    max_length=512)
                for dev, model in zip(("cpu", "cuda"),
                                      small_model(torch, cfg, 7))}
    expression = "the person on the left holding a red umbrella"
    for task in ("panoptic", "semantic", "referring"):
        kw = {"expression": expression} if task == "referring" else {}
        replies = {dev: svc.segment(image, task, **kw)
                   for dev, svc in services.items()}
        maps = [_reply_map(np, task, replies[dev], hw)
                for dev in ("cpu", "cuda")]
        agree = float(np.mean(maps[0] == maps[1]))
        what = f"maps agree on {agree:.6f}"
        if task == "panoptic" and not replies["cpu"]["segments"]:
            fail("small segment panoptic: the CPU's reply holds no segment")
        if agree < SMALL_AGREE:
            fail(f"small segment {task}: {what}")
        if task == "referring":
            d = abs(replies["cuda"]["score"] - replies["cpu"]["score"])
            if not d <= 1e-3:
                fail(f"small segment referring: scores differ by {d}")
            what += f", scores differ by {d:.2e}"
        log(f"  {task}: {what}")


def segment_slice(torch, np, card, records):
    """Phase 13: a port controller and a port worker on localhost; the
    client finds the worker through the controller and POSTs
    /worker_segment once per task after a warm-up request per task. Returns
    the launches of the three timed requests. K5 is held against its plain
    version on Phi's layer-0 q, k, v of a request (L = 2048)."""
    from psalm_tpu_torch import PSALMConfig
    from psalm_tpu_torch.models import phi
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.ops import flash_attention
    from psalm_tpu_torch.serve import controller
    from psalm_tpu_torch.serve.model_worker import ModelWorker, make_handler
    cfg = PSALMConfig(compute_dtype="bfloat16")
    model = PSALM(cfg, dtype=torch.bfloat16, device="cuda", use_flash=True)
    init_weights_(model, torch.Generator(device="cuda").manual_seed(13))
    with torch.no_grad():  # so that panoptic queries pass the 0.8 threshold
        model.predictor.CLASS_proj.layers[-1].weight.mul_(10.0)
    model.to(torch.bfloat16)
    csrv, curl = serve_http(controller.make_handler(controller.Controller()))
    wsrv, wurl = serve_http(None)  # its handler once the worker exists
    worker = ModelWorker(curl, wurl, None, "psalm-segment",
                         image_size=cfg.image_size, device="cuda",
                         model=model,
                         tokenizer=WordTokenizer(cfg.phi.vocab_size))
    wsrv.RequestHandlerClass = make_handler(worker)
    image = jpeg_b64(np, SEGMENT_HW, 13)
    expression = " ".join(np.random.default_rng(13).choice(SENTENCE_WORDS,
                                                           SEGMENT_WORDS))
    requests = {"panoptic": {}, "semantic": {},
                "referring": {"expression": expression}}
    seen, inputs = {}, {}  # Phi's sequence length -> K5 launches, (q, k, v)

    def watched(q, k, v, **kw):
        seen[q.shape[2]] = seen.get(q.shape[2], 0) + 1
        if q.shape[2] not in inputs:
            inputs[q.shape[2]] = (q.clone(), k.clone(), v.clone())
        return kernel(q, k, v, **kw)

    ms, what = {}, {}
    try:
        addr = post_json(curl + "/get_worker_address",
                         {"model": "psalm-segment"})["address"]
        if addr != wurl:
            fail(f"the controller gave {addr!r} for the worker at {wurl}")
        for task, extra in requests.items():  # each task's runner, warm
            post_json(addr + "/worker_segment",
                      {"image": image, "task": task, **extra})
        kernel, phi.flash_attention = phi.flash_attention, watched
        torch.cuda.synchronize()
        zero_counts()
        for task, extra in requests.items():
            t0 = time.perf_counter()
            reply = post_json(addr + "/worker_segment",
                              {"image": image, "task": task, **extra})
            ms[task] = (time.perf_counter() - t0) * 1e3
            what[task] = check_segment_reply(np, task, reply, SEGMENT_HW)
            if task == "panoptic" and not reply["segments"]:
                fail("segment panoptic: the reply holds no segment")
        counts = launch_counts()
    finally:
        if phi.flash_attention is watched:
            phi.flash_attention = kernel
        for srv in (wsrv, csrv):
            srv.shutdown()
            srv.server_close()
    per_request = expected(K1=cfg.pixel_decoder.transformer_enc_layers,
                           K3=sum(cfg.swin.depths),
                           K5_causal=cfg.phi.num_layers)
    expect = {k: v * len(requests) for k, v in per_request.items()}
    for task in requests:
        log(f"segment {task}: {ms[task]:.1f} ms a request (HTTP to the "
            f"worker, a {SEGMENT_HW[0]}x{SEGMENT_HW[1]} JPEG, after a "
            f"warm-up request) on {card}; {what[task]}")
    log(f"segment: launches {counts} (expected {expect}); K5 causal by "
        f"Phi's sequence length {seen}")
    if counts != expect:
        fail(f"segment: kernel launches {counts} != {expect}")
    if set(seen) != {2048}:
        fail(f"segment: Phi ran at {sorted(seen)}, not the padded 2048")
    log("K5 causal on a segment request's own attention inputs (Phi layer 0)")
    hold_k5(flash_attention, records, *inputs[2048], True,
            " (phase 13 activations)")
    del worker, model, inputs
    gc.collect()
    return {"segment": counts}


def run_davis(model, cfg, tokenizer, paths, out_dir, limit,
              max_length=2048):
    """The DAVIS CLI's ``evaluation`` on the tree, its printout kept out of
    the log: (results, wall seconds)."""
    import argparse
    import contextlib
    import io
    from psalm_tpu_torch import SegTask
    from psalm_tpu_torch.eval.eval_davis import evaluation
    root, json_path = paths
    args = argparse.Namespace(model_path="", json_path=json_path,
                              image_folder=root, output_dir=out_dir,
                              with_memory=True, model_max_length=max_length,
                              limit=limit)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = evaluation(args, cfg=cfg.replace(seg_task=SegTask.REGION),
                         tokenizer=tokenizer, model=model)
    return res, time.perf_counter() - t0


def read_davis_pngs(np, paths, out_dir, n):
    """Every frame's PNG read back: (P mode with the DAVIS palette, the
    frame's size, indices in {0} and the objects' fills): {frame: array}."""
    from PIL import Image
    from psalm_tpu_torch.eval.eval_davis import davis_palette
    with open(paths[1]) as f:
        records = json.load(f)[:n]
    out = {}
    for rec in records:
        video = rec["image"].split("/")[-2]
        name = os.path.splitext(os.path.basename(rec["image"]))[0]
        img = Image.open(os.path.join(out_dir, video, name + ".png"))
        pal = bytes(img.getpalette() or b"")
        arr = np.asarray(img)
        fills = {int(a["category_id"]) for a in rec["first_frame_anns"]}
        if img.mode != "P" or pal != davis_palette()[:len(pal)] or not pal:
            fail(f"davis {video}/{name}.png: mode {img.mode}, not the palette")
        if arr.shape != DAVIS_HW or not set(np.unique(arr).tolist()) <= \
                {0} | fills:
            fail(f"davis {video}/{name}.png: {arr.shape}, indices "
                 f"{np.unique(arr).tolist()} beside the fills {fills}")
        out[f"{video}/{name}"] = arr
    return out


def check_small_davis(torch, np, paths):
    """Tiny config (Phi use_flash, 2 heads of 32) in f32: the DAVIS CLI with
    the kernels on the card against the plain versions on the CPU, same
    weights, same tree: every frame's PNG agrees on 99% of pixels and the
    same frames take their prompts from the memory."""
    import shutil
    cfg = small_cfg()
    tokenizer = WordTokenizer(cfg.phi.vocab_size)
    root = os.path.join(HERE, "build", "davis_small")
    shutil.rmtree(root, ignore_errors=True)
    res, pngs = {}, {}
    # seed 8: the CPU's run takes the memory in a few frames (seed 7 in none)
    for dev, model in zip(("cpu", "cuda"), small_model(torch, cfg, 8)):
        out = os.path.join(root, dev)
        res[dev] = run_davis(model, cfg, tokenizer, paths, out, 0,
                             max_length=512)[0]
        pngs[dev] = read_davis_pngs(np, paths, out, res[dev]["frames"])
    agree = {k: float(np.mean(pngs["cpu"][k] == pngs["cuda"][k]))
             for k in pngs["cpu"]}
    if res["cpu"]["memory"] != res["cuda"]["memory"]:
        fail(f"small davis: memory {res['cuda']['memory']} on the card, "
             f"{res['cpu']['memory']} on the CPU")
    if min(agree.values()) < SMALL_AGREE:
        fail(f"small davis: PNG agreement {agree}")
    filled = sum(int((a > 0).sum()) for a in pngs["cpu"].values())
    if not any(res["cpu"]["memory"]) or not filled:
        fail(f"small davis: the CPU's run takes the memory in no frame "
             f"({res['cpu']['memory']}) or segments nothing ({filled})")
    log(f"  {len(agree)} frames: PNGs agree on {min(agree.values()):.6f} at "
        f"worst; memory {res['cpu']['memory']} on both; {filled} object "
        f"pixels on the CPU")


def davis_slice(torch, np, card, paths):
    """Phase 14: the DAVIS CLI at full width; returns the launches of its
    timed run over every frame of the tree."""
    import shutil
    from psalm_tpu_torch import PSALMConfig
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    cfg = PSALMConfig(compute_dtype="bfloat16")
    model = PSALM(cfg, dtype=torch.bfloat16, device="cuda", use_flash=True)
    init_weights_(model, torch.Generator(device="cuda").manual_seed(14))
    model.to(torch.bfloat16)
    tokenizer = WordTokenizer(cfg.phi.vocab_size)
    root = os.path.join(HERE, "build", "davis_out")
    shutil.rmtree(root, ignore_errors=True)
    run_davis(model, cfg, tokenizer, paths, os.path.join(root, "warmup"), 1)
    torch.cuda.synchronize()
    zero_counts()
    res, wall = run_davis(model, cfg, tokenizer, paths,
                          os.path.join(root, "out"), 0)
    counts = launch_counts()
    n = res["frames"]
    # Swin and the projector run twice a frame: the frame and the prompt's
    expect = expected(K1=cfg.pixel_decoder.transformer_enc_layers * n,
                      K3=2 * sum(cfg.swin.depths) * n,
                      K5_causal=cfg.phi.num_layers * n)
    pngs = read_davis_pngs(np, paths, os.path.join(root, "out"), n)
    filled = sum(int((a > 0).sum()) for a in pngs.values())
    log(f"davis: {n / wall:.3f} frames/s ({n} frames of {DAVIS_HW[0]}x"
        f"{DAVIS_HW[1]}, {DAVIS_VIDEOS} videos, {DAVIS_OBJECTS} objects, "
        f"{wall / n * 1e3:.1f} ms a frame; the CLI's own figure "
        f"{res['fps']:.3f}) on {card}; memory {res['memory']}; {len(pngs)} "
        f"PNGs read back with the palette, {filled} object pixels; launches "
        f"{counts} (expected {expect})")
    if counts != expect:
        fail(f"davis: kernel launches {counts} != {expect}")
    del model
    gc.collect()
    return {"davis": counts}


# -- training entry point, tower training and QLoRA (phases 15-17) ---------

# the logged values of train_log.jsonl (and the TensorBoard tags)
TRAIN_LOGGED = ("loss_mask", "loss_dice", "loss_SEG_class",
                "loss_class_name_class", "loss_region_class", "loss_llm",
                "loss", "grad_norm")
# the training CLI: the first main call's steps, then the resumed call's
CLI_TRAIN_STEPS = (4, 6)
CLI_PROFILE = ("1,2", "4,5")  # each call's traced steps
LORA_RANK, LORA_ALPHA, LORA_LR, LORA_STEPS, LORA_LEN = 64, 16.0, 1e-2, 3, 512
# merged bf16 Phi against the adapted (QLoRA) one, x max |logit|: bf16
# weights and activations through 24 layers, as K4_TOL for the decode step
LORA_MERGE_TOL = 5e-2
# the kernels' names in a CUDA trace: K1, K2, K3 (and K3's backward)
TRACE_NAMES = {"K1": "msdeform_fwd", "K2": "msdeform_bwd",
               "K3": "window_attention_tc_kernel"}


def write_train_tree(np, root, n_images, hw, n_thing, n_stuff, seed,
                     segments=CLI_SEGMENTS, anns=CLI_ANNS):
    """``write_cli_tree``'s COCO tree with its val2017 split copied as the
    train2017 split the training datasets read, and a LLaVA-format chat
    JSON (mm_conv) of one round an image. Returns the paths and the chat
    JSON's."""
    import shutil
    paths = write_cli_tree(np, root, n_images, hw, n_thing, n_stuff,
                           segments, anns, SEM_CLASSES, seed)
    coco = paths["root"]
    for d in ("", "panoptic_"):
        shutil.copytree(os.path.join(coco, f"{d}val2017"),
                        os.path.join(coco, f"{d}train2017"),
                        dirs_exist_ok=True)
    shutil.copy(os.path.join(coco, "annotations/panoptic_val2017.json"),
                os.path.join(coco, "annotations/panoptic_train2017.json"))
    rng = np.random.default_rng(seed + 1)

    def words(n):
        return " ".join(rng.choice(SENTENCE_WORDS, n))

    # one round: the label masking's per-round token counts assume a BPE
    # tokenizer past the first round (WordTokenizer's would mask it all)
    chats = [{"id": i, "image": f"{i:012d}.jpg", "conversations": [
        {"from": "human", "value": f"<image>\n{words(8)}?"},
        {"from": "gpt", "value": words(24) + "."}]} for i in range(n_images)]
    paths["mm_conv"] = os.path.join(root, "mm_conv.json")
    with open(paths["mm_conv"], "w") as f:
        json.dump(chats, f)
    return paths


def train_argv(paths, model_dir, out, steps, device, extra=()):
    """main's flags: the four task datasets of the tree at ratio 1 each (a
    panoptic, region, referring and mm_conv batch in turn), batch 1, a log
    line a step, keep-1 checkpoints."""
    return ["--output_dir", out, "--model_name_or_path", model_dir,
            "--panoptic_json_path", paths["root"],
            "--region_json_path", paths["instance_json"],
            "--ref_coco_path", paths["instance_json"],
            "--mmconv_path", paths["mm_conv"],
            "--image_folder", paths["images"], "--data_ratio", "1||1||1||1",
            "--per_device_train_batch_size", "1", "--num_train_steps",
            str(steps), "--save_total_limit", "1", "--logging_steps", "1",
            "--seed", "15", "--device", device, *extra]


def write_model_dir(torch, model, cfg, path):
    """A checkpoint directory of ``model``'s weights in bf16 (as a released
    checkpoint stores them) and its config."""
    from psalm_tpu_torch.config import config_to_json
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in model.state_dict().items()},
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "psalm_tpu_config.json"), "w") as f:
        f.write(config_to_json(cfg))


def read_log(path):
    with open(os.path.join(path, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def fixed_criterion(ttrain, draws):
    """ttrain.PSALMCriterion with ``draws`` as its point draws (main builds
    its own Trainer and criterion)."""

    class Criterion(ttrain.PSALMCriterion):
        def __init__(self, *a, **kw):
            kw["uniform_fn"] = draws
            super().__init__(*a, **kw)

    return Criterion


def check_small_train_cli(torch, np):
    """Tiny config in f32: the training CLI on a small tree on the card
    against the same on the CPU: one model directory, the same point draws,
    no loader threads, and the card's run fed the CPU's samples (the
    panoptic dataset shuffles its class names with Python's random, which
    other code in the process may draw from too). lr 1e-7: Adam moves an
    entry by about lr whatever its gradient's size, so the float dust that
    differs between the two devices would part their parameters by lr a
    step. Every logged loss and grad norm within 1e-3 relative."""
    import shutil
    from psalm_tpu_torch import tiny_test_config
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.train import train as ttrain
    root = os.path.join(HERE, "build", "train_cli_small")
    shutil.rmtree(root, ignore_errors=True)
    # at most 10 masks an image: the tiny config has 10 queries
    paths = write_train_tree(np, root, 2, (96, 128), 8, 4, seed=16,
                             segments=6, anns=4)
    cfg = tiny_test_config()
    model = init_weights_(PSALM(cfg, device="cpu"),
                          torch.Generator().manual_seed(16))
    model_dir = os.path.join(root, "model")
    write_model_dir(torch, model, cfg, model_dir)
    real = ttrain.PSALMCriterion, ttrain.collate
    samples = []

    def record(batch):
        samples.append(batch)
        return real[1](batch)

    def replay(batch):
        want = samples.pop(0)
        if [s["dataset_type"] for s in batch] != \
                [s["dataset_type"] for s in want]:
            fail("small training CLI: the card drew another dataset")
        return real[1](want)

    ttrain.PSALMCriterion = fixed_criterion(ttrain, FixedDraws(np, torch))
    logs = {}
    try:
        for dev, collate in (("cpu", record), ("cuda", replay)):
            ttrain.collate = collate
            out = os.path.join(root, f"out_{dev}")
            ttrain.main(train_argv(paths, model_dir, out, 4, dev, (
                "--bf16", "0", "--model_max_length", "512",
                "--learning_rate", "1e-7", "--dataloader_num_workers", "0")),
                tokenizer=WordTokenizer(cfg.phi.vocab_size))
            logs[dev] = read_log(out)
    finally:
        ttrain.PSALMCriterion, ttrain.collate = real
    for w, g in zip(logs["cpu"], logs["cuda"]):
        for k in TRAIN_LOGGED:
            if not abs(g[k] - w[k]) <= 1e-3 * abs(w[k]):
                fail(f"small training CLI step {w['step']} "
                     f"({w['dataset_type']}) {k}: card {g[k]} vs CPU {w[k]}")
    log(f"  training CLI: {len(logs['cuda'])} steps "
        f"({', '.join(l['dataset_type'] for l in logs['cuda'])}), losses and "
        f"grad norm within 1e-3 of the CPU (last loss "
        f"{logs['cuda'][-1]['loss']:.6f} vs {logs['cpu'][-1]['loss']:.6f})")


def check_small_backbone(torch, np):
    """Tiny config in f32: two tower-training steps (PSALM(train_backbone=
    True), drop path at its rates with the same fixed draws) on the card
    against the CPU: losses and grad norm within 1e-3, and K3's backward
    launched once a block a step."""
    from psalm_tpu_torch import tiny_test_config
    from psalm_tpu_torch.data.datasets import SyntheticPanopticDataset, collate
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.train.train import Trainer
    cfg, steps = tiny_test_config(), 2
    draws = FixedDraws(np, torch)
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  4, num_samples=2, num_masks=3,
                                  valid_masks=2, seed=3)
    batch = collate([ds[0], ds[1]])
    cpu = init_weights_(PSALM(cfg, device="cpu", remat=True,
                              train_backbone=True),
                        torch.Generator().manual_seed(17))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = PSALM(cfg, device=dev, remat=True, train_backbone=True)
        model.load_state_dict(cpu.state_dict())
        model.model.vision_tower.uniform_fn = draws
        trainer = Trainer(train_args(bf16=False, warmup_ratio=0.1,
                                     num_train_steps=10, train_backbone=True),
                          cfg, model=model, device=dev, uniform_fn=draws)
        zero_counts()
        runs[dev] = ([{k: float(v) for k, v in trainer.step(batch).items()}
                      for _ in range(steps)], launch_counts())
    (want, _), (got, counts) = runs["cpu"], runs["cuda"]
    for i, (w, g) in enumerate(zip(want, got)):
        for key in ("loss_mask", "loss_dice", "loss_class_name_class",
                    "loss", "grad_norm"):
            if not abs(g[key] - w[key]) <= 1e-3 * abs(w[key]):
                fail(f"small tower training step {i} {key}: card {g[key]} vs "
                     f"CPU {w[key]}")
    enc = cfg.pixel_decoder.transformer_enc_layers
    blocks = sum(cfg.swin.depths)
    expect = expected(K3=blocks * steps, K3_backward=blocks * steps,
                      K1=2 * enc * steps, K2=enc * steps)
    if counts != expect:
        fail(f"small tower training: launches {counts} != {expect}")
    log(f"  tower training: {steps} steps within 1e-3 of the CPU (loss "
        f"{got[-1]['loss']:.6f} vs {want[-1]['loss']:.6f}, grad norm "
        f"{got[-1]['grad_norm']:.6f} vs {want[-1]['grad_norm']:.6f}); "
        f"launches {counts}")


def phi_lm(torch, phi_cfg, dtype, device):
    """Phi with its lm_head (``model.*``, ``lm_head.*``), as PSALM holds
    them, for the LoRA phases."""
    from psalm_tpu_torch.models.layers import Dense
    from psalm_tpu_torch.models.phi import PhiModel

    class PhiLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = PhiModel(phi_cfg, dtype=dtype, device=device)
            self.lm_head = Dense(phi_cfg.hidden_size, phi_cfg.vocab_size,
                                 bias=phi_cfg.lm_head_bias, dtype=dtype,
                                 device=device)

        def forward(self, ids):
            return self.lm_head(self.model(self.model.embed(ids)))

    return PhiLM()


def qlora_model(torch, phi_cfg, dtype, device, seed):
    """(QLoRA Phi LM on ``device``, its float base state dict): random base
    weights from ``seed``, quantized to int8 (``quantize_phi_int8``) and
    grafted under LoRA adapters of ``phi_cfg``'s rank, A ~ N(0, 0.02^2)
    from the same generator, B = 0."""
    import dataclasses
    from psalm_tpu_torch.models.layers import LoRADense
    from psalm_tpu_torch.models.psalm import init_weights_
    from psalm_tpu_torch.models.quant import quantize_phi_int8
    from psalm_tpu_torch.train.lora import graft_base_params
    gen = torch.Generator(device=device).manual_seed(seed)
    base_cfg = dataclasses.replace(phi_cfg, lora_rank=0, quant_bits=0)
    base = init_weights_(phi_lm(torch, base_cfg, dtype, device), gen)
    base_sd = {k: v.detach() for k, v in base.state_dict().items()}
    del base
    model = phi_lm(torch, phi_cfg, dtype, device)
    for mod in model.modules():
        if isinstance(mod, LoRADense):
            mod.reset_adapters(gen)
    model.load_state_dict(graft_base_params(model.state_dict(),
                                            quantize_phi_int8(base_sd)))
    return model, base_sd


def lora_steps(torch, model, ids, steps, lr):
    """``steps`` train_steps of next-token CE on ``ids`` under
    psalm_finetune_optimizer; returns the losses."""
    from psalm_tpu_torch.train.lora import psalm_finetune_optimizer
    from psalm_tpu_torch.train.train import llm_ce_loss
    from psalm_tpu_torch.train.train_step import TrainState, train_step
    opt = psalm_finetune_optimizer(model, lr=lr, total_steps=steps,
                                   warmup_ratio=0.0)
    state = TrainState(0, model, opt)

    def loss_fn(batch, generator):
        loss = llm_ce_loss(model(batch), batch)
        return loss, {"loss_llm": loss.detach()}

    gen = torch.Generator(device=ids.device)
    return [float(train_step(state, loss_fn, ids, gen)["loss"])
            for _ in range(steps)], opt


def check_small_lora(torch, np):
    """Tiny Phi, QLoRA (rank 4 on the int8 base), f32: two train_steps
    under psalm_finetune_optimizer on the card against the CPU from the
    same weights: losses and the final logits within 1e-3."""
    import dataclasses
    from psalm_tpu_torch import tiny_test_config
    phi_cfg = dataclasses.replace(tiny_test_config().phi, lora_rank=4,
                                  quant_bits=8)
    cpu, _ = qlora_model(torch, phi_cfg, torch.float32, "cpu", 18)
    ids = torch.from_numpy(np.random.default_rng(18).integers(
        3, phi_cfg.vocab_size, (2, 64)))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = phi_lm(torch, phi_cfg, torch.float32, dev)
        model.load_state_dict(cpu.state_dict())
        # lr 1e-4: Adam moves an entry by about lr whatever its gradient's
        # size, so the devices' float dust parts them by lr a step
        losses, _ = lora_steps(torch, model, ids.to(dev), 3, 1e-4)
        with torch.no_grad():
            runs[dev] = (losses, model(ids.to(dev)).float().cpu())
    (wl, wlog), (gl, glog) = runs["cpu"], runs["cuda"]
    for i, (w, g) in enumerate(zip(wl, gl)):
        if not abs(g - w) <= 1e-3 * abs(w):
            fail(f"small QLoRA step {i}: loss card {g} vs CPU {w}")
    err = (glog - wlog).abs().max().item()
    if not err <= 1e-3 * wlog.abs().max().item():
        fail(f"small QLoRA: logits differ by {err}")
    log(f"  QLoRA: 3 steps, losses {[round(v, 6) for v in gl]} within 1e-3 "
        f"of the CPU's {[round(v, 6) for v in wl]}; logits within "
        f"{err:.2e}")


def trace_kernels(path):
    """The CUDA kernels' names in a Chrome trace written by torch.profiler."""
    with open(path) as f:
        trace = json.load(f)
    return {e.get("name", "") for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel"}


def train_cli_slice(torch, np, card):
    """Phase 15: main at the full published width from a model directory of
    seeded random weights, twice (the second resumes); returns the
    launches of both calls."""
    import shutil
    from psalm_tpu_torch.config import PSALMConfig
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    from psalm_tpu_torch.train import train as ttrain
    try:
        import tensorboard  # noqa: F401
        report = ["--report_to", "tensorboard"]
    except ImportError:
        report = []
        log("  tensorboard does not import here: --report_to none (the CPU "
            "test holds the TensorBoard path)")
    root = os.path.join(HERE, "build", "train_cli")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_train_tree(np, root, CLI_IMAGES, CLI_HW, 80, 53, seed=15)
    cfg = PSALMConfig()
    model_dir = os.path.join(root, "model")
    model = init_weights_(PSALM(cfg, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(15))
    write_model_dir(torch, model, cfg, model_dir)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  tree and model directory written in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(root, "out")
    steps = []  # (dataset type, ms, launches) of every step
    real_step = ttrain.Trainer.step

    def timed_step(self, batch_np):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = real_step(self, batch_np)
        torch.cuda.synchronize()
        after = launch_counts()
        steps.append((batch_np["dataset_type"],
                      (time.perf_counter() - t) * 1e3,
                      {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}))
        return metrics

    torch.cuda.reset_peak_memory_stats()
    calls = []
    ttrain.Trainer.step = timed_step
    try:
        for n, profile in zip(CLI_TRAIN_STEPS, CLI_PROFILE):
            argv = train_argv(paths, model_dir, out, n, "cuda", (
                "--dataloader_num_workers", "2", "--save_steps", "1000",
                "--profile_steps", profile, *report))
            zero_counts()
            t = time.perf_counter()
            state = ttrain.main(argv, tokenizer=WordTokenizer(
                cfg.phi.vocab_size))
            calls.append((state.step, state.optimizer.count,
                          time.perf_counter() - t, launch_counts(),
                          sorted(os.listdir(out))))
    finally:
        ttrain.Trainer.step = real_step
    lines = read_log(out)
    first, second = CLI_TRAIN_STEPS
    if [l["step"] for l in lines] != list(range(second)):
        fail(f"training CLI: logged steps {[l['step'] for l in lines]}")
    for l in lines:
        if not all(np.isfinite(l[k]) for k in TRAIN_LOGGED):
            fail(f"training CLI: non-finite log line {l}")
        if not l["loss"] > 0:  # every batch, the chat one too, has a loss
            fail(f"training CLI: a zero loss at step {l['step']} ({l})")
    for (step, count, _, _, dirs), n in zip(calls, CLI_TRAIN_STEPS):
        ckpts = [d for d in dirs if d.startswith("checkpoint-")]
        if step != n or count != n or ckpts != [f"checkpoint-{n}"]:
            fail(f"training CLI: after {n} steps the state is at step {step}"
                 f" (optimizer {count}) with checkpoints {ckpts}")
    if len(steps) != second or steps[first][0] != lines[first]["dataset_type"]:
        fail(f"training CLI: the resumed call did not start at step {first}")
    types = [l["dataset_type"] for l in lines[:4]]
    if sorted(types) != ["mm_conv", "panoptic_coco", "referring_coco",
                         "region_coco"]:
        fail(f"training CLI: the first four batches are {types}")
    traced = {}
    for profile in CLI_PROFILE:
        path = os.path.join(out, "trace_steps_%s_%s.json"
                            % tuple(profile.split(",")))
        if not os.path.exists(path):
            fail(f"training CLI: no profiler trace {path}")
        names = trace_kernels(path)
        traced[profile] = {k: any(v in n for n in names)
                           for k, v in TRACE_NAMES.items()}
        log(f"  trace of steps {profile}: {len(names)} kernel names, "
            f"{traced[profile]}")
    if not any(all(t.values()) for t in traced.values()):
        fail(f"training CLI: no profiler trace names K1, K2 and K3 "
             f"({traced})")
    if report:
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator
        acc = EventAccumulator(os.path.join(out, "tb"))
        acc.Reload()
        for k in TRAIN_LOGGED + ("step",):
            got = [(e.step, e.value) for e in acc.Scalars(k)]
            want = [(l["step"], l[k]) for l in lines]
            if [s for s, _ in got] != [s for s, _ in want] or not np.allclose(
                    [v for _, v in got], [v for _, v in want], rtol=1e-6):
                fail(f"training CLI: TensorBoard {k} {got} != log {want}")
        log(f"  TensorBoard: {len(TRAIN_LOGGED) + 1} scalars of "
            f"{len(lines)} steps read back equal to train_log.jsonl")
    by_type = {}
    for kind, ms, _ in steps:
        by_type.setdefault(kind, []).append(round(ms, 1))
    log(f"training CLI on {card}: {second} steps in two calls (resumed at "
        f"step {first}), batch 1, bf16 compute, f32 parameters, 2 loader "
        f"threads; step ms by dataset type {by_type} (each type's first "
        f"step warms up); calls {[round(c[2], 1) for c in calls]} s "
        f"(model load, checkpoint save and resume included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches a "
        f"step {[(kind, counts) for kind, _, counts in steps]}")
    launches = {}
    for i, call in enumerate(calls):
        counts = call[3]
        for k in ("K1", "K2", "K3"):
            if counts[k] == 0:
                fail(f"training CLI call {i + 1}: no {k} launch ({counts})")
        if counts["K3 backward"] or counts["K4"]:
            fail(f"training CLI call {i + 1}: the frozen tower and no int4 "
                 f"layer launch no K3 backward or K4 ({counts})")
        launches[f"train cli/call {i + 1}"] = counts
    return launches


def train_backbone_slice(torch, np, card):
    """Phase 16: Trainer.step of PSALM(train_backbone=True) at the full
    published width in the deformable mode; returns the timed steps'
    launches. K3's backward is held per element on the step's own stage-0
    inputs."""
    from psalm_tpu_torch.data.datasets import (SyntheticPanopticDataset,
                                               UnifiedTaskSampler, collate)
    from psalm_tpu_torch.ops import swin_attention
    from psalm_tpu_torch.train.train import Trainer, build_train_config
    args = train_args(train_backbone=True)
    cfg = build_train_config(args)
    K, timed = cfg.num_classes + 1, 3
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(args, cfg, device="cuda")
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  K, num_samples=4, num_masks=16)
    sampler = UnifiedTaskSampler([ds], batch_size=1)
    batches = [collate(sampler.next_batch()) for _ in range(1 + timed)]
    tower = dict((n, p) for n, p in trainer.trainable
                 if n.startswith("model.vision_tower."))
    watch = ["model.vision_tower.patch_embed.proj.weight",
             "model.vision_tower.layers.0.blocks.0.attn.qkv.weight",
             "model.vision_tower.layers.0.blocks.1.attn."
             "relative_position_bias_table",
             "model.vision_tower.layers.3.blocks.1.mlp.fc2.weight"]
    start = {k: tower[k].detach().clone() for k in watch}
    # the warm-up step (lr 0) keeps K3's backward inputs at stage 0
    captured = []
    real_bwd = swin_attention.window_attention_bwd

    res = -(-cfg.image_size // cfg.swin.patch_size)
    stage0 = (-(-res // cfg.swin.window_size)) ** 2  # 484 at 1024^2

    def keep(qkv, bias, mask, nheads, scale, dout):
        if qkv.shape[0] == stage0:
            captured.append(((qkv, bias, mask, nheads, scale), dout))
        return real_bwd(qkv, bias, mask, nheads, scale, dout)

    swin_attention.window_attention_bwd = keep
    try:
        t0 = time.perf_counter()
        trainer.step(batches[0])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        swin_attention.window_attention_bwd = real_bwd
    if any(not torch.equal(tower[k], start[k]) for k in watch):
        fail("tower training: the first update (lr 0) moved the tower")
    zero_counts()
    times = []
    for i, batch in enumerate(batches[1:]):
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    values = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"tower training: non-finite metrics {values}")
    bad = [n for n, p in tower.items()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad:
        fail(f"tower training: missing or non-finite gradients {bad[:5]}")
    still = [k for k in watch if torch.equal(tower[k], start[k])]
    if still:
        fail(f"tower training: the tower did not move: {still}")
    enc = cfg.pixel_decoder.transformer_enc_layers
    blocks = sum(cfg.swin.depths)
    expect = expected(K1=2 * enc * timed, K2=enc * timed, K3=blocks * timed,
                      K3_backward=blocks * timed)
    log(f"launches in the {timed} timed steps: {counts} (expected {expect})")
    if counts != expect:
        fail(f"tower training: kernel launches {counts} != {expect}")
    log(f"tower training on {card}: step ms "
        f"{[round(t * 1e3, 2) for t in times]} (median "
        f"{sorted(times)[len(times) // 2] * 1e3:.2f}; warm-up "
        f"{warm_s * 1e3:.0f} ms), batch 1, bf16 compute, f32 parameters, "
        f"drop path 0-{cfg.swin.drop_path_rate}; last step "
        + ", ".join(f"{k} {v:.5f}" for k, v in values.items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; launches per step "
        + ", ".join(f"{k} {v // timed}" for k, v in counts.items() if v))
    del trainer, batches, tower
    gc.collect()
    if {a[2] is None for a, _ in captured} != {True, False}:
        fail(f"tower training: {len(captured)} stage-0 backward calls kept")
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        for args, dout in captured:
            name = (f"K3 backward on the tower step's stage-0 inputs "
                    f"({'shift-mask' if args[2] is not None else 'no-mask'})")
            _, _, worst = hold_k3_bwd(torch, swin_attention, name, args, dout)
            log(f"  {name}: worst {worst} of the limit")
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    return {"train backbone": counts}


def lora_slice(torch, np, card):
    """Phase 17: QLoRA at the full published Phi width: rank 64 adapters
    on the int8 base, psalm_finetune_optimizer, 3 train_steps; the base
    stays bit for bit, the adapters move, and merge_lora gives a bf16 Phi
    whose logits agree with the adapted one's."""
    import dataclasses
    from psalm_tpu_torch.config import PSALMConfig
    from psalm_tpu_torch.train import lora
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phi_cfg = dataclasses.replace(PSALMConfig().phi, lora_rank=LORA_RANK,
                                  lora_alpha=LORA_ALPHA, quant_bits=8)
    model, _ = qlora_model(torch, phi_cfg, torch.bfloat16, "cuda", 19)
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if not lora.is_lora(k)}
    adapters = {k: v.clone() for k, v in model.state_dict().items()
                if lora.is_lora(k)}
    n_int8 = sum(v.dtype == torch.int8 for v in frozen.values())
    ids = torch.randint(3, phi_cfg.vocab_size, (1, LORA_LEN),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(19), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, opt = lora_steps(torch, model, ids, LORA_STEPS, LORA_LR)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / LORA_STEPS
    if not all(np.isfinite(losses)):
        fail(f"QLoRA: non-finite losses {losses}")
    sd = model.state_dict()
    moved = [k for k in frozen if not torch.equal(sd[k], frozen[k])]
    if moved:
        fail(f"QLoRA: frozen base tensors changed: {moved[:5]}")
    still = [k for k, v in adapters.items()
             if k.endswith(".lora_B") and torch.equal(sd[k], v)]
    if still:
        fail(f"QLoRA: adapters that did not move: {still[:5]}")
    n_train = sum(p.numel() for p in opt.params)
    merged_sd = lora.merge_lora(sd, alpha=LORA_ALPHA)
    with torch.no_grad():
        adapted = model(ids).float()
        for k in adapters:  # the base alone: every B at zero
            if k.endswith(".lora_B"):
                model.get_parameter(k).zero_()
        base = model(ids).float()
    del model, sd
    gc.collect()
    merged = phi_lm(torch, dataclasses.replace(phi_cfg, lora_rank=0,
                                               quant_bits=0),
                    torch.bfloat16, "cuda")
    merged.load_state_dict({k: v.to(torch.bfloat16) if v.is_floating_point()
                            else v for k, v in merged_sd.items()},
                           assign=True)
    with torch.no_grad():
        got = merged(ids).float()
    scale = adapted.abs().max().item()
    err = (got - adapted).abs().max().item()
    effect = (base - adapted).abs().max().item()
    log(f"QLoRA on {card}: Phi-1.5 int8 base ({n_int8} int8 tensors), rank "
        f"{LORA_RANK} adapters, {n_train / 1e6:.2f} M trained parameters, "
        f"{LORA_STEPS} steps of {LORA_LEN} tokens at lr {LORA_LR}: losses "
        f"{[round(v, 5) for v in losses]}, {step_ms:.1f} ms a step, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; every int8 "
        f"base tensor unchanged, every B moved; merged bf16 logits within "
        f"{err:.4f} of the adapted ones (limit {LORA_MERGE_TOL} x "
        f"{scale:.3f}; the adapters move them by {effect:.4f})")
    if not err <= LORA_MERGE_TOL * scale:
        fail(f"QLoRA: merged logits differ by {err} > {LORA_MERGE_TOL} x "
             f"{scale}")
    del merged


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
    check_k3_bwd(torch, swin_attention, records)

    log("== small slice (tiny config, f32: card kernels vs CPU plain)")
    check_small_slice(torch, np)
    check_small_tasks(torch, np)

    log("== eval slice (PSALMConfig(), bf16, EvalRunner.infer)")
    path_ms = {}  # K1's and K2's device ms per launch on the paths
    timings = {}  # phase 5's p50, which phase 12 sets its CLIs beside
    eval_launches = eval_slice(torch, np, card, path_ms, timings)
    torch.cuda.empty_cache()

    log("== serving slice (PSALMConfig(), int4 'pallas' Phi, bf16, ModelWorker)")
    serve_launches = serving_slice(torch, np, card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    log("== eval tasks (PSALMConfig(), bf16, use_flash, EvalRunner.infer)")
    paths = {"eval": eval_launches, **serve_launches}
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
    torch.cuda.empty_cache()

    log("== small CLIs (tiny config, f32: card kernels vs CPU plain)")
    check_small_clis(torch, np)

    log("== eval CLIs (PSALMConfig(), bf16, use_flash, evaluation(...))")
    paths.update(clis_slice(torch, np, card, timings, records))
    torch.cuda.empty_cache()

    log("== small segment service (tiny config, f32: card kernels vs CPU plain)")
    check_small_segment(torch, np)

    log("== segment (a port controller and worker on localhost, "
        "PSALMConfig(), bf16, use_flash, /worker_segment)")
    paths.update(segment_slice(torch, np, card, records))
    torch.cuda.empty_cache()

    log("== davis (tiny config, f32, card vs CPU; then PSALMConfig(), bf16, "
        "use_flash, eval_davis.evaluation)")
    davis = write_davis_tree(np, os.path.join(HERE, "build", "davis"),
                             DAVIS_VIDEOS, DAVIS_FRAMES, DAVIS_HW,
                             DAVIS_OBJECTS, seed=14)
    check_small_davis(torch, np, davis)
    paths.update(davis_slice(torch, np, card, davis))
    torch.cuda.empty_cache()

    log("== small training CLI, tower training and QLoRA (tiny config, f32: "
        "card kernels vs CPU plain)")
    check_small_train_cli(torch, np)
    check_small_backbone(torch, np)
    check_small_lora(torch, np)

    log("== training CLI (train.py::main, PSALMConfig(), bf16, 2 calls: "
        "the second resumes)")
    paths.update(train_cli_slice(torch, np, card))
    torch.cuda.empty_cache()

    log("== tower training (PSALMConfig(), PSALM(train_backbone=True), "
        "deformable, bf16, Trainer.step)")
    paths.update(train_backbone_slice(torch, np, card))
    torch.cuda.empty_cache()

    log("== QLoRA (Phi-1.5, rank 64 on the int8 base, "
        "psalm_finetune_optimizer, train_step)")
    lora_slice(torch, np, card)

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
