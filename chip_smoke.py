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
                 K3 Swin window attention: each Swin-B stage of a 1024^2
                    image (window 12, N=144, head dim 32), with and without
                    the shift mask; bf16 and f32;
                 K4 int4 matvec: Phi-1.5's decode linears, (K, N) = (2048,
                    2048) q/k/v/dense, (2048, 8192) fc1, (8192, 2048) fc2,
                    group 64, B = 1, 4, 16, x in bf16 and f32; exact on
                    one-hot rows with power-of-two scales.
  4. small   - the whole eval slice at the tiny config in f32: kernels on the
               card against the plain versions on the CPU, same weights.
  5. eval    - the COCO-panoptic eval path (EvalRunner.infer) at the full
               published width (PSALMConfig(): Swin-B, Phi-1.5, 6 encoder and
               9 decoder layers) in bf16, with random weights drawn on the card
               from a seeded torch.Generator, on bench.py's geometry (content
               768x1024 in the 1024^2 frame, original 480x640, bucket 640x640,
               81 class names of 3 tokens, sequence padded to 640). The launch
               counters are zeroed just before the timed runs and must show
               every kernel on the path (6 K1 and 24 K3 launches per image).
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

f32 comparisons run with TF32 off. On the line before the last: a JSON object
with each kernel's checks, launches, times and bound. The last line is
{"ok": true, "device": ...}. Any failure exits nonzero before that line. The
script imports nothing of JAX and nothing of psalm_tpu (it checks both).
"""

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

K4_SHAPES = ((2048, 2048, "q/k/v/dense"), (2048, 8192, "fc1"),
             (8192, 2048, "fc2"))
SOURCES = {
    "K1": ("psalm_tpu_torch/csrc/msdeform.cu",
           # also replaces msdeform_window_pallas2.py:115, the same function,
           # which no model path of psalm_tpu calls
           "psalm_tpu/ops/msdeform_window_pallas3.py:149"),
    "K3": ("psalm_tpu_torch/csrc/swin_attention.cu",
           "psalm_tpu/ops/swin_attention_pallas.py:82"),
    "K4": ("psalm_tpu_torch/csrc/int4_matvec.cu",
           "psalm_tpu/ops/int4_matvec.py:86"),
}


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


def device_ms(fn, iters=20, warmup=3):
    """Device time per call of fn: the summed duration of the kernels and
    copies it launches, from torch.profiler's CUDA trace, over ``iters``
    calls. Fails where the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        fail("torch.profiler recorded no device events: no device time")
    return us / iters / 1e3


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
    ms = device_ms(fn)
    call_ms = cuda_time_ms(fn)
    plain_ms = device_ms(plain_fn, iters=10)
    library_ms = device_ms(library_fn) if library_fn is not None else None
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), kernel {ms:.4f} ms "
        f"(call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})")
    if not err <= tol:
        fail(f"{name}: max abs err {err} > {tol}")
    records.append({"kernel": kernel, "name": name, "max_abs_err": err,
                    "tol": tol, "ms": ms, "call_ms": call_ms,
                    "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                    "library_ms": library_ms})


def check_k1(torch, msdeform, records):
    shapes = ((32, 32), (64, 64), (128, 128))  # res5, res4, res3 at 1024^2
    B, M, D, L, P = 1, 8, 32, 3, 4
    S = sum(h * w for h, w in shapes)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    from psalm_tpu_torch.models.pixel_decoder import reference_points
    ref = torch.from_numpy(reference_points(shapes)).to(dev)  # [S, L, 2]
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=dev)
    # offsets to +-12 target-level px: beyond radius 8 and off the border
    off = (torch.rand(B, S, M, L, P, 2, generator=g, device=dev) * 2 - 1) * 12
    loc = (ref[None, :, None, :, None, :]
           + off / norm[None, None, None, :, None, :]).contiguous()
    value32 = torch.randn(B, S, M, D, generator=g, device=dev)
    attn32 = torch.softmax(torch.randn(B, S, M, L * P, generator=g, device=dev),
                           -1).reshape(B, S, M, L, P)
    starts = msdeform.level_starts(shapes)
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
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
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            # no single PyTorch call computes the multi-level deformable sum
            record(records, "K1", f"K1 ms_deform_attn {dtype_name(dtype)} "
                   f"radius={radius}", err, tol,
                   lambda: msdeform.ms_deform_attn(*args, radius=radius),
                   lambda: msdeform.ms_deform_attn_ref(*args, radius=radius),
                   None, bound(nbytes, flops, dtype_name(dtype)))


def check_k3(torch, swin_attention, records):
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
        for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
            qkv = qkv32.to(dtype).contiguous()
            q, k, v = (t.reshape(nW, N, h, hd).transpose(1, 2).contiguous()
                       for t in qkv.split(C, dim=-1))
            for m in (None, mask):
                args = (qkv, bias, m, h, hd ** -0.5)
                got = swin_attention.window_attention(*args)
                want = swin_attention.window_attention_ref(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                am = (bias[None] if m is None else bias[None] + m[:, None])
                am = am.to(dtype).contiguous()
                elt = qkv.element_size()
                nbytes = qkv.numel() * elt + bias.numel() * 4 \
                    + (m.numel() * 4 if m is not None else 0) \
                    + nW * N * C * elt
                flops = 4 * nW * h * N * N * hd  # q k^T and p v
                record(records, "K3", f"K3 window_attention {dtype_name(dtype)} "
                       f"stage{stage} Bn={nW} C={C} h={h} "
                       f"{'shift-mask' if m is not None else 'no-mask'}",
                       err, tol,
                       lambda: swin_attention.window_attention(*args),
                       lambda: swin_attention.window_attention_ref(*args),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=am, scale=hd ** -0.5),
                       bound(nbytes, flops, dtype_name(dtype)))


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
        for B in (1, 4, 16):
            x32 = torch.randn(B, K, generator=g, device=dev)
            hot32 = torch.zeros(B, K, device=dev)
            hot32[torch.arange(B, device=dev),
                  torch.randperm(K, generator=g, device=dev)[:B]] = 1.0
            for dtype in (torch.bfloat16, torch.float32):
                x, hot = x32.to(dtype), hot32.to(dtype)
                name = (f"K4 int4_matvec {dtype_name(dtype)} {which} B={B} "
                        f"K={K} N={N} g={group}")
                got = int4_matvec.int4_matvec(hot, packed, pow2, group)
                want = int4_matvec.int4_matvec_ref(hot, packed, pow2, group)
                if not torch.equal(got, want):
                    fail(f"{name}: not exact on one-hot rows, max err "
                         f"{(got - want).abs().max().item()}")
                got = int4_matvec.int4_matvec(x, packed, scale, group)
                want = int4_matvec.int4_matvec_ref(x, packed, scale, group)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                # f32 sums in another order: 1e-5 of the output's size
                tol = 1e-5 * want.abs().max().item()
                w_lib = w_deq.to(dtype)
                nbytes = x.numel() * x.element_size() + packed.numel() \
                    + scale.numel() * 4 + B * N * 4
                record(records, "K4", name, err, tol,
                       lambda: int4_matvec.int4_matvec(x, packed, scale, group),
                       lambda: int4_matvec.int4_matvec_ref(x, packed, scale,
                                                           group),
                       lambda: torch.matmul(x, w_lib),
                       # int4 values are exact in bf16: x's type sets the rate
                       bound(nbytes, 2 * B * K * N, dtype_name(dtype)))
                if dtype == torch.bfloat16:
                    if B == 1:  # built and checked once per weight
                        int4pack = int4pack_call(torch, packed, scale, group,
                                                 lambda: (x, want))
                    records[-1]["int4pack_ms"] = (
                        device_ms(lambda: int4pack(x)) if int4pack else None)
                    log(f"    _weight_int4pack_mm: "
                        f"{records[-1]['int4pack_ms']} ms")


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


def eval_slice(torch, np, card, msdeform, swin_attention):
    """Phase 5; returns the kernels' launches in the timed run."""
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
    if tuple(pm.shape) != (1, cfg.mask_decoder.num_queries, 256, 256) \
            or tuple(cl.shape) != (1, cfg.mask_decoder.num_queries, K):
        fail(f"output shapes {tuple(pm.shape)} {tuple(cl.shape)}")
    if not (torch.isfinite(pm.float()).all() and torch.isfinite(cl.float()).all()):
        fail("non-finite pred_masks or class logits")
    for _ in range(2):  # warm-up
        runner.infer(batch)
    torch.cuda.synchronize()

    msdeform.LAUNCHES = 0
    swin_attention.LAUNCHES = 0
    times = []
    t_all = time.perf_counter()
    for _ in range(TIMED_IMAGES):
        t0 = time.perf_counter()
        res = runner.infer(batch)  # ends in a device-to-host copy
        times.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = {"K1": msdeform.LAUNCHES, "K3": swin_attention.LAUNCHES}
    expect = {"K1": cfg.pixel_decoder.transformer_enc_layers * TIMED_IMAGES,
              "K3": sum(cfg.swin.depths) * TIMED_IMAGES}
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
    return launches


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        toks, _ = gen.decode_chunk(last, cache, temp, 8, rng)
        toks.cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        fail("torch.profiler recorded no device events in the decode steps")
    return prefill_ms, step_ms, busy_us / wall_us


def serving_slice(torch, np, card, int4_matvec, swin_attention, msdeform):
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
    int4_matvec.LAUNCHES = swin_attention.LAUNCHES = msdeform.LAUNCHES = 0
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
    launches = {"K1": msdeform.LAUNCHES, "K3": swin_attention.LAUNCHES,
                "K4": int4_matvec.LAUNCHES}
    expect = {"K1": 0, "K3": sum(cfg.swin.depths) * gen.prefills,
              "K4": 6 * cfg.phi.num_layers * gen.decode_steps}
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
    from psalm_tpu_torch.ops import _build, int4_matvec, msdeform, swin_attention
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")

    log("== kernels (kernel vs plain PyTorch on the card)")
    records = []
    check_k1(torch, msdeform, records)
    check_k3(torch, swin_attention, records)
    check_k4(torch, int4_matvec, records)

    log("== small slice (tiny config, f32: card kernels vs CPU plain)")
    check_small_slice(torch, np)

    log("== eval slice (PSALMConfig(), bf16, EvalRunner.infer)")
    eval_launches = eval_slice(torch, np, card, msdeform, swin_attention)
    torch.cuda.empty_cache()

    log("== serving slice (PSALMConfig(), int4 'pallas' Phi, bf16, ModelWorker)")
    serve_launches = serving_slice(torch, np, card, int4_matvec,
                                   swin_attention, msdeform)

    bad = [m for m in sys.modules if m in ("jax", "flax", "optax")
           or m == "psalm_tpu" or m.startswith("psalm_tpu.")]
    if bad:
        fail(f"JAX or psalm_tpu modules were imported: {bad}")

    kernels = []
    for r in records:
        k = r["kernel"]
        by_path = {"eval": eval_launches.get(k, 0),
                   "serve": serve_launches.get(k, 0)}
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[k][0],
            "replaces": SOURCES[k][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
            "tol": r["tol"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"int4pack_ms": r["int4pack_ms"]} if "int4pack_ms" in r else {})})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
