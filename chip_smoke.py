#!/usr/bin/env python3
"""Smoke run of psalm_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, each of which must pass:
  1. device  - the card's name and power limit (nvidia-smi).
  2. build   - the CUDA kernels of psalm_tpu_torch/csrc, compiled by nvcc for
               sm_90a into build/psalm_tpu_torch/.
  3. kernels - each kernel against its plain PyTorch version on the card, at
               the shapes the eval path gives it, with kernel and plain times
               (CUDA events, median of 20 launches):
                 K1 deformable sampler: B=1, S=Q=21504 (32^2+64^2+128^2),
                    M=8, D=32, L=3, P=4; bf16 and f32; exact and radius=8,
                    with offsets beyond the radius and off the image border;
                 K3 Swin window attention: each Swin-B stage of a 1024^2
                    image (window 12, N=144, head dim 32), with and without
                    the shift mask; bf16 and f32.
  4. small   - the whole eval slice at the tiny config in f32: kernels on the
               card against the plain versions on the CPU, same weights.
  5. slice   - the COCO-panoptic eval path (EvalRunner.infer) at the full
               published width (PSALMConfig(): Swin-B, Phi-1.5, 6 encoder and
               9 decoder layers) in bf16, with random weights drawn on the card
               from a seeded torch.Generator, on bench.py's geometry (content
               768x1024 in the 1024^2 frame, original 480x640, bucket 640x640,
               81 class names of 3 tokens, sequence padded to 640). The launch
               counters are zeroed just before the timed runs and must show
               every kernel on the path (6 K1 and 24 K3 launches per image).

f32 comparisons run with TF32 off. The line before the last is a JSON object
with each kernel's check; the last line is {"ok": true, "device": ...}. Any
failure exits nonzero before that line. The port shares psalm_tpu's
numpy-only config and splicer modules; nothing of JAX is imported.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's geometry
CONTENT_HW = (768, 1024)
ORIGINAL_HW = (480, 640)
BUCKET_HW = (640, 640)
TIMED_IMAGES = 5


def log(msg):
    print(msg, flush=True)


def fail(msg, code=1):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_time_ms(fn, iters=20, warmup=3):
    """Median over ``iters`` launches of fn, timed with CUDA events."""
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
        for radius in (None, 8.0):
            args = (value, shapes, starts, loc, attn)
            got = msdeform.ms_deform_attn(*args, radius=radius)
            want = msdeform.ms_deform_attn_ref(*args, radius=radius)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ms = cuda_time_ms(lambda: msdeform.ms_deform_attn(*args, radius=radius))
            plain_ms = cuda_time_ms(
                lambda: msdeform.ms_deform_attn_ref(*args, radius=radius), iters=10)
            name = (f"K1 ms_deform_attn {str(dtype).split('.')[-1]} "
                    f"radius={radius}")
            log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not err <= tol:
                fail(f"{name}: max abs err {err} > {tol}")
            records.append({"kernel": "K1", "name": name, "max_abs_err": err,
                            "tol": tol, "ms": ms, "plain_ms": plain_ms})


def check_k3(torch, swin_attention, records):
    from psalm_tpu_torch.models.swin import shift_attn_mask
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    ws, N = 12, 144
    for stage, (res, C, h) in enumerate(((256, 128, 4), (128, 256, 8),
                                         (64, 512, 16), (32, 1024, 32))):
        Hp = -(-res // ws) * ws
        nW = (Hp // ws) ** 2
        qkv32 = torch.randn(nW, N, 3 * C, generator=g, device=dev)
        bias = torch.randn(h, N, N, generator=g, device=dev)
        mask = torch.from_numpy(shift_attn_mask(Hp, Hp, ws, ws // 2)).to(dev)
        for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
            qkv = qkv32.to(dtype).contiguous()
            for m in (None, mask):
                args = (qkv, bias, m, h, (C // h) ** -0.5)
                got = swin_attention.window_attention(*args)
                want = swin_attention.window_attention_ref(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ms = cuda_time_ms(lambda: swin_attention.window_attention(*args))
                plain_ms = cuda_time_ms(
                    lambda: swin_attention.window_attention_ref(*args), iters=10)
                name = (f"K3 window_attention {str(dtype).split('.')[-1]} "
                        f"stage{stage} Bn={nW} C={C} h={h} "
                        f"{'shift-mask' if m is not None else 'no-mask'}")
                log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
                if not err <= tol:
                    fail(f"{name}: max abs err {err} > {tol}")
                records.append({"kernel": "K3", "name": name,
                                "max_abs_err": err, "tol": tol, "ms": ms,
                                "plain_ms": plain_ms})


def check_small_slice(torch, np):
    """Tiny config, f32: kernels on the card vs plain versions on the CPU."""
    from psalm_tpu_torch import tiny_test_config
    from psalm_tpu_torch.eval.runner import EvalRunner, synthetic_panoptic_batch
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    cfg = tiny_test_config()
    K = 4
    cpu = init_weights_(PSALM(cfg), torch.Generator().manual_seed(7))
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
    from psalm_tpu_torch.ops import _build, msdeform, swin_attention
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")

    log("== kernels (kernel vs plain PyTorch on the card)")
    records = []
    check_k1(torch, msdeform, records)
    check_k3(torch, swin_attention, records)

    log("== small slice (tiny config, f32: card kernels vs CPU plain)")
    check_small_slice(torch, np)

    log("== slice (PSALMConfig(), bf16, EvalRunner.infer)")
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
    log(f"slice: p50 {p50 * 1e3:.2f} ms, {TIMED_IMAGES / wall:.3f} img/s "
        f"({TIMED_IMAGES} images, batch 1, bf16) on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    bad = [m for m in ("jax", "flax", "optax") if m in sys.modules]
    if bad:
        fail(f"JAX modules were imported: {bad}")

    # K1 also replaces msdeform_window_pallas2.py:115, which computes the same
    # function and which no model path of psalm_tpu calls
    sources = {"K1": ("psalm_tpu_torch/csrc/msdeform.cu",
                      "psalm_tpu/ops/msdeform_window_pallas3.py:149"),
               "K3": ("psalm_tpu_torch/csrc/swin_attention.cu",
                      "psalm_tpu/ops/swin_attention_pallas.py:82")}
    kernels = [{"name": r["name"], "route": "cuda",
                "source": sources[r["kernel"]][0],
                "replaces": sources[r["kernel"]][1],
                "launches": launches[r["kernel"]],
                "max_abs_err": r["max_abs_err"], "tol": r["tol"],
                "ms": r["ms"], "plain_ms": r["plain_ms"]} for r in records]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
