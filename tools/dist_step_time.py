#!/usr/bin/env python3
"""Step time of the distributed trainer at the full published width, one
process a card (NCCL), for each mesh given as DATAxMODEL:

    python3 tools/dist_step_time.py [1x1 4x1 2x2 plain ...]   # data x model
    python3 tools/dist_step_time.py --lora_rank 64 --quant_bits 8 4x1 2x2

Each mesh runs ``Trainer(args, PSALMConfig(), mesh=mesh)`` (chip_smoke.py
phase 10's recipe: deformable, bf16 compute, f32 parameters, gradient
checkpointing, batch 1 a data rank; random weights from seed 0, the same on
every rank; each data rank its own ``SyntheticPanopticDataset`` sample): a
warm-up step, then 3 timed steps (host clock to a synchronize and a
barrier), then one step under ``torch.profiler``: the NCCL kernels' and the
device-to-device copies' time on rank 0, and the peak memory. Before the
meshes, the cards' topology (``nvidia-smi topo -m``, where the machine
allows it) and ``dryrun_multichip(N, "cuda")`` on every card. One JSON line
a mesh, with the card's name and power limit. The kernels are built once,
before the processes start. ``plain`` runs the same steps on one card with a
``Trainer`` without a mesh (the one-process optimizer), to set beside 1x1.
``--lora_rank R`` puts rank-R adapters on Phi's linears and ``--quant_bits
8`` (or 4) quantizes Phi's base: the model is loaded as ``main``'s builder
loads one (``chip_smoke.qlora_psalm``: random float weights from the seed,
quantized, the adapters drawn; each rank its slices), and with LoRA the
trainer trains ``psalm_finetune_mask``'s parameters (QLoRA with both).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TIMED = 3


def rank_steps(model_par, lora_rank=0, quant_bits=0):
    """One rank of a mesh of the whole group (``model_par`` 0: a Trainer
    without a mesh): its step times and, on rank 0, the traced step's NCCL
    and copy time and the peak memory."""
    import torch
    import torch.distributed as dist

    from chip_smoke import qlora_psalm, train_args
    from psalm_tpu_torch.data.datasets import SyntheticPanopticDataset, collate
    from psalm_tpu_torch.parallel.mesh import make_mesh
    from psalm_tpu_torch.train.train import Trainer, build_train_config
    mesh = make_mesh(model=model_par, device="cuda") if model_par else None
    data, data_rank = (mesh.data, mesh.data_rank) if mesh else (1, 0)
    args = train_args(lora_rank=lora_rank)
    cfg = build_train_config(args)
    cfg = cfg.replace(phi=dataclasses.replace(cfg.phi, quant_bits=quant_bits))
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  cfg.num_classes + 1, num_samples=data,
                                  num_masks=16)
    batch = collate([ds[data_rank]])
    torch.cuda.reset_peak_memory_stats()
    model = (qlora_psalm(torch, cfg, args, torch.bfloat16, mesh)
             if lora_rank or quant_bits else None)
    trainer = Trainer(args, cfg, model=model, device="cuda", mesh=mesh)
    trainer.step(batch)
    times = []
    for _ in range(TIMED):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def ms(pick):
        return sum(e.time_range.elapsed_us() for e in events if pick(e)) / 1e3

    return {"rank": mesh.rank if mesh else 0, "step_ms": times,
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "traced_ms": wall, "device_busy_ms": ms(lambda e: True),
            "nccl_ms": ms(lambda e: "nccl" in e.name.lower()),
            "dtod_ms": ms(lambda e: "DtoD" in e.name),
            "nccl_kernels": sorted({e.name for e in events
                                    if "nccl" in e.name.lower()})[:6]}


def main(meshes, lora_rank=0, quant_bits=0):
    import torch

    from psalm_tpu_torch.ops import _build
    from psalm_tpu_torch.parallel.dryrun import dryrun_multichip
    from psalm_tpu_torch.parallel.launch import spawn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    n_cards = torch.cuda.device_count()
    print(f"cards: {card}", flush=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    print(topo.stdout, flush=True)
    _build.build()
    t0 = time.perf_counter()
    dry = dryrun_multichip(n_cards, device="cuda")
    print(json.dumps({"dryrun_multichip": n_cards, "s": time.perf_counter() - t0,
                      "mesh": [dry[0]["data"], dry[0]["model"]],
                      "loss": dry[0]["metrics"]["loss"],
                      "same_on_every_rank": all(r["metrics"] == dry[0]["metrics"]
                                                for r in dry)}), flush=True)
    for spec in meshes:
        # plain: one process, model 0 = no mesh
        data, model = (1, 0) if spec == "plain" else map(int, spec.split("x"))
        t0 = time.perf_counter()
        ranks = spawn("tools.dist_step_time:rank_steps", data * max(model, 1),
                      (model, lora_rank, quant_bits), device="cuda",
                      threads=4, timeout=1200)
        r0 = ranks[0]
        print(json.dumps({
            "mesh": spec, "lora_rank": lora_rank, "quant_bits": quant_bits,
            "cards": card[:data * max(model, 1)],
            "step_ms": r0["step_ms"],
            "median_ms": sorted(r0["step_ms"])[TIMED // 2],
            "peak_gib": max(r["peak_gib"] for r in ranks),
            "traced_ms": r0["traced_ms"],
            "device_busy_ms": r0["device_busy_ms"], "nccl_ms": r0["nccl_ms"],
            "nccl_share": r0["nccl_ms"] / r0["traced_ms"],
            "dtod_ms": r0["dtod_ms"], "nccl_kernels": r0["nccl_kernels"],
            "loss": r0["loss"], "grad_norm": r0["grad_norm"],
            "same_loss_on_every_rank": all(r["loss"] == r0["loss"]
                                           for r in ranks),
            "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("meshes", nargs="*", default=["1x1"],
                        help="DATAxMODEL, or plain")
    parser.add_argument("--lora_rank", type=int, default=0)
    parser.add_argument("--quant_bits", type=int, default=0, choices=(0, 4, 8))
    opts = parser.parse_args()
    main(opts.meshes, opts.lora_rank, opts.quant_bits)
