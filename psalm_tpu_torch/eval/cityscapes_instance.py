"""Cityscapes instance-segmentation evaluation CLI.

Reference: psalm/eval/segmentation_evaluation/Cityscapes_evaluation.py
(CityscapesInstanceEvaluator) — the reference delegates to the cityscapes
scripts toolkit; here the same mask-AP metric is computed by the
self-contained InstanceAPEvaluator over the 8 cityscapes thing classes, on
PSALM-format instance records (see datasets_prep/build_coco_instance.py for
the record schema; cityscapes annotations convert the same way).

Counterpart of ``psalm_tpu/eval/cityscapes_instance.py``, with the same flags
and result keys. ``evaluation(args, cfg, tokenizer, model)`` takes an
injected port model (the weights live in it) or loads ``--model_path``
on the card (``runner.load_eval_model``); the device is the model's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from psalm_tpu_torch.config import PSALMConfig, SegTask
from psalm_tpu_torch.data.datasets import DataConfig, InstanceDataset, collate
from psalm_tpu_torch.eval.metrics import InstanceAPEvaluator
from psalm_tpu_torch.eval.runner import EvalRunner, load_eval_model

CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]


class CityscapesInstanceDataset(InstanceDataset):
    dataset_type = "instance_cityscapes"

    def __init__(self, json_path, image_folder, tokenizer, cfg, is_train=False):
        super().__init__(json_path, image_folder, tokenizer, cfg, is_train)
        self.coco_class_name = CITYSCAPES_THING_CLASSES + ["background"]
        self.coco_id_to_cont_id = {i: i for i in
                                   range(len(CITYSCAPES_THING_CLASSES))}


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--json_path", required=True)
    p.add_argument("--image_folder", required=True)
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--seq_bucket", type=int, default=128,
                   help="pad token sequences to the batch max rounded up "
                        "to this multiple instead of model_max_length "
                        "(0 = fixed pad; outputs identical either way)")
    p.add_argument("--limit", type=int, default=0)
    return p.parse_args()


def evaluation(args, cfg=None, tokenizer=None, model=None):
    if model is None:
        tokenizer, model, cfg = load_eval_model(args.model_path,
                                                SegTask.INSTANCE, cfg)
    cfg = cfg or PSALMConfig(seg_task=SegTask.INSTANCE)

    dcfg = DataConfig(image_size=cfg.image_size,
                      num_image_tokens=(cfg.image_size // 64) ** 2,
                      num_seg_queries=cfg.mask_decoder.num_queries,
                      pad_len=args.model_max_length)
    ds = CityscapesInstanceDataset(args.json_path, args.image_folder,
                                   tokenizer, dcfg)
    K = len(ds.coco_class_name)
    runner = EvalRunner(model, cfg, num_class_names=K)
    evaluator = InstanceAPEvaluator(list(range(K - 1)))

    n = min(len(ds), args.limit) if args.limit else len(ds)
    t0 = time.time()
    for i in range(n):
        s = ds[i]
        out = runner.infer(collate([s], seq_bucket=getattr(args, "seq_bucket", 128)))
        inst = out["instances"]
        rh, ow = s["resized_hw"], s["original_hw"]
        masks = inst["masks"][0]  # already at original resolution
        n_gt = int(s["gt_valid"].sum())
        gt_masks = EvalRunner.restore_masks(
            s["gt_masks"][:n_gt].astype(np.uint8), rh, ow) if n_gt else \
            np.zeros((0, *ow), np.uint8)
        evaluator.add_image(masks.astype(bool), inst["scores"][0],
                            inst["classes"][0], gt_masks.astype(bool),
                            s["gt_labels"][:n_gt])

    results = {"cityscapes_instance": evaluator.summarize(),
               "images_per_sec": n / (time.time() - t0)}
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    evaluation(parse_args())
