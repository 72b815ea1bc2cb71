"""The FLOPs of one image (eval) or one training sample, by module, at a
cell's shapes, frozen into ``counts/<workload>.json``:

    python3 h100_bench/counts/derive.py eval_panoptic_b8 [...]

The reference model is built on the ``meta`` device (shapes only, no
memory, no arithmetic) and run once on one row of the cell's first batch
under ``torch.utils.flop_counter.FlopCounterMode``, which counts 2 m n k
for every matrix product and convolution from its shapes. Two corrections
follow, both written into the file:

* The language model's. The work the reference does and the program's
  kernels skip, its kind's ``skipped_flops`` (``h100_bench/lm/``), is taken
  off. Phi's: the reference computes the whole L x L score matrix and masks
  it; the work the causal product needs (and kernel K5 does) is half of it:
  2 L^2 D a layer for q k^T and P v together, in place of 4 L^2 D. The
  difference, 24 x 2 L^2 D, is taken off (``causal_saving``).
* Training. The work of a sample is the frozen tower's forward once and
  the rest of the model three times (forward, and a backward of twice its
  cost), not counting what gradient checkpointing computes again.

Checks a reader can make at the published widths (D = 2048, MLP 8192, 24
layers): Phi's linears 24 x (8 D^2 + 4 D I) = 2.416 GFLOP a token, 1.856
TFLOP at L = 768; causal attention 24 x 2 L^2 D = 58.0 GFLOP at L = 768;
Swin-B at 1024^2 about 0.68 TFLOP (each of its 24 blocks 24 C^2 FLOPs a
token in linears, 4 N C a token in attention over windows of N = 144, plus
the patch embedding and merges); the pixel decoder about 0.29 TFLOP.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: modules whose FLOPs the file lists beside the language model's layers
#: (FlopCounterMode's names; one ending in "." sums its numbered children,
#: the layers of a ModuleList)
MODULES = {"swin": "PSALM.model.vision_tower",
           "projector": "PSALM.model.mm_projector",
           "pixel_decoder": "PSALM.pixel_decoder",
           "mask_decoder": "PSALM.predictor"}


def first_row(config: Dict[str, Any], mix: Dict[str, Any], cfg):
    """Row 0 of the mix's first batch (seed 0: the sizes do not depend on
    the seed), as tensors on ``meta``."""
    from h100_bench.gen import batches
    nq = cfg.mask_decoder.num_queries
    if mix["kind"] == "eval":
        b = batches.eval_batch(dict(mix, batch=1), cfg.image_size, nq, 0, 0)
    else:
        b = batches.train_batch(dict(mix, batch=1), cfg.image_size, nq, 0, 0)
    host = {"padding_mask", "resized_hw", "original_hw", "gt_masks",
            "gt_labels", "gt_valid", "image_id", "dataset_type",
            "num_class_names"}
    return {k: torch.as_tensor(v).to("meta") for k, v in b.items()
            if k not in host}


def task_flags(mix: Dict[str, Any]) -> Dict[str, Any]:
    """The model's keyword flags for the mix's task, as the port's
    ``EvalRunner`` and ``Trainer`` pass them."""
    if mix.get("task", "panoptic") == "referring":
        return dict(use_class_names=False, use_seg_embedding=True)
    return dict(use_class_names=True, num_class_names=mix["class_names"])


def derive(config: Dict[str, Any], mix: Dict[str, Any]) -> Dict[str, Any]:
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench import lm
    from h100_bench.reference.psalm import PSALM
    from h100_bench.weights import reference_config
    cfg = reference_config(config)
    kind = lm.module(cfg.language_model)
    model = PSALM(cfg, dtype=torch.float32, device="meta")
    model.requires_grad_(False)
    batch = first_row(config, mix, cfg)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(batch, **task_flags(mix))
    by_module = {k: sum(v.values())
                 for k, v in counter.get_flop_counts().items()}
    named = {**MODULES, kind.COUNTS_KEY: kind.COUNTS_LAYERS}
    modules = {short: (sum(v for k, v in by_module.items()
                           if k.startswith(name)
                           and k.count(".") == name.count("."))
                       if name.endswith(".") else by_module.get(name, 0))
               for short, name in named.items()}
    L = int(batch["tok_ids"].shape[1])
    skipped = {k: int(v) for k, v in kind.skipped_flops(cfg.lm, L).items()}
    forward = counter.get_total_flops() - sum(skipped.values())
    modules[kind.COUNTS_KEY] -= sum(skipped.values())
    modules["rest"] = forward - sum(modules.values())
    if mix["kind"] == "eval":
        per, flops = "image", forward
        how = f"forward at the cell's shapes, {kind.COUNTS_NOTE}"
    else:
        per = "sample"
        flops = modules["swin"] + 3 * (forward - modules["swin"])
        how = ("the frozen tower's forward once and the rest three times "
               f"(forward and backward), {kind.COUNTS_NOTE}, no recompute")
    return {"per": per, "flops": int(flops), "forward_flops": int(forward),
            "sequence_length": L, "modules": {k: int(v) for k, v in
                                              modules.items()},
            **skipped, "derivation": how}


def main(workloads) -> None:
    from h100_bench.common import cell
    for name in workloads:
        c = cell(name)
        counts = derive(c["config"], c["traffic"])
        with open(HERE / f"{name}.json", "w") as f:
            json.dump(counts, f, indent=1, sort_keys=True)
            f.write("\n")
        print(name, counts["per"], counts["flops"] / 1e12, "TFLOP")


if __name__ == "__main__":
    main(sys.argv[1:])
