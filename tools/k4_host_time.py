#!/usr/bin/env python3
"""Host time around K4: microseconds of host clock per call of the K4
wrapper and of a ``Quant4Dense`` layer (storage "pallas"), and the int4
decode step, for the checkout at ROOT (this script's own by default).

    python3 tools/k4_host_time.py [ROOT]      # one card

To compare two versions on one card, run it from both checkouts in turns
in one chip command (parent, change, change, parent): a decode step is
host-bound, and host time moves from call to call.
  layer / wrapper  3000 calls after 100 warm-up ones, without a
                   synchronize in between, so that the host clock reads
                   the host's time a call (K4's device time is a tenth of
                   it); the wrapper is called as Quant4Dense calls it.
  decode           chip_smoke.time_decode three times: ms a step of
                   Phi-1.5 in int4 with random weights, B = 1 and 4.
"""

import dataclasses
import inspect
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from psalm_tpu_torch import PSALMConfig  # noqa: E402
from psalm_tpu_torch.models.builder import model_from_state_dict  # noqa: E402
from psalm_tpu_torch.models.generation import Generator  # noqa: E402
from psalm_tpu_torch.models.psalm import PSALM, init_weights_  # noqa: E402
from psalm_tpu_torch.models.quant import (Quant4Dense,  # noqa: E402
                                          quantize_kernel_int4)
from psalm_tpu_torch.ops import int4_matvec as k4  # noqa: E402

CALLS, WARMUP = 3000, 100


def host_us(fn):
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return us


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    tag = os.path.basename(ROOT)
    # the wrapper as Quant4Dense calls it: the weight checked once, where
    # this version has that
    checked = ({"weight_checked": True} if "weight_checked" in
               inspect.signature(k4.int4_matvec).parameters else {})
    for K, N, which in smoke.K4_SHAPES:
        layer = Quant4Dense(K, N, dtype=torch.bfloat16, storage="pallas",
                            device="cuda")
        packed, scale = quantize_kernel_int4(
            torch.randn(K, N, device="cuda") * K ** -0.5, 64)
        layer.packed.copy_(packed)
        layer.scale.copy_(scale)
        for B in (1, 4):
            x = torch.randn(B, 1, K, device="cuda", dtype=torch.bfloat16)
            x2 = x.reshape(B, K)
            layer_us = host_us(lambda: layer(x))
            wrapper_us = host_us(lambda: k4.int4_matvec(
                x2, layer.packed, layer.scale, 64, **checked))
            print(f"[{tag}] {which} B={B}: host us a call, layer "
                  f"{layer_us:.2f}, wrapper {wrapper_us:.2f}", flush=True)

    base_cfg = PSALMConfig(compute_dtype="bfloat16")
    cfg = base_cfg.replace(phi=dataclasses.replace(base_cfg.phi,
                                                   quant_storage="pallas"))
    base = PSALM(cfg, dtype=torch.bfloat16, device="cuda")
    init_weights_(base, torch.Generator(device="cuda").manual_seed(1))
    sd = base.state_dict()
    del base
    model = model_from_state_dict(sd, cfg, dtype=torch.bfloat16,
                                  device="cuda", load_4bit=True)
    del sd
    gen = Generator(model, max_len=2048, device="cuda")
    image = np.random.default_rng(0).standard_normal(
        (1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    for B in (1, 4):
        batch = smoke.chat_batch(np, smoke.StubTokenizer(),
                                 "<image>\nDescribe the image.", image, B)
        steps = [smoke.time_decode(torch, gen, batch)[1] for _ in range(3)]
        print(f"[{tag}] int4 decode B={B}: ms a step "
              f"{', '.join(f'{s:.3f}' for s in steps)}", flush=True)


if __name__ == "__main__":
    main()
