"""COCO instance-segmentation evaluation CLI (reference:
psalm/eval/instance_segmentation.py — mask AP).

Counterpart of ``psalm_tpu/eval/instance_segmentation.py``, with the same flags
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


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--json_path", required=True)
    p.add_argument("--image_folder", required=True)
    p.add_argument("--eval_batch_size", type=int, default=1)
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--seq_bucket", type=int, default=128,
                   help="pad token sequences to the batch max rounded up "
                        "to this multiple instead of model_max_length "
                        "(0 = fixed pad; outputs identical either way)")
    p.add_argument("--output_dir", default=None)
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
    ds = InstanceDataset(args.json_path, args.image_folder, tokenizer, dcfg,
                         is_train=False)
    K = len(ds.coco_class_name)
    from psalm_tpu_torch.eval.runner import bucket_for_sizes
    bucket = (bucket_for_sizes(ds.image_sizes)
              if getattr(ds, 'image_sizes', None) else None)
    runner = EvalRunner(model, cfg, bucket_hw=bucket, num_class_names=K)
    evaluator = InstanceAPEvaluator(list(range(K - 1)))
    writer = None
    if args.output_dir:
        from psalm_tpu_torch.eval.artifacts import InstanceResultsWriter
        cont_to_dataset = {v: k for k, v in ds.coco_id_to_cont_id.items()}
        writer = InstanceResultsWriter(args.output_dir, cont_to_dataset)

    n = min(len(ds), args.limit) if args.limit else len(ds)
    t0 = time.time()
    for i in range(0, n, args.eval_batch_size):
        samples = [ds[j] for j in range(i, min(i + args.eval_batch_size, n))]
        batch = collate(samples, seq_bucket=getattr(args, "seq_bucket", 128))
        out = runner.infer(batch)
        inst = out["instances"]
        for b, s in enumerate(samples):
            rh, ow = s["resized_hw"], s["original_hw"]
            masks = inst["masks"][b]  # already at original resolution
            n_gt = int(s["gt_valid"].sum())
            gt_masks = EvalRunner.restore_masks(
                s["gt_masks"][:n_gt].astype(np.uint8), rh, ow) if n_gt else \
                np.zeros((0, *ow), np.uint8)
            evaluator.add_image(masks.astype(bool), inst["scores"][b],
                                inst["classes"][b], gt_masks.astype(bool),
                                s["gt_labels"][:n_gt])
            if writer is not None:
                writer.add(int(s["image_id"]), masks.astype(bool),
                           inst["scores"][b], inst["classes"][b])
        if i % 50 == 0:
            print(f"[{i}/{n}]")

    results = {"instance": evaluator.summarize(),
               "images_per_sec": n / (time.time() - t0)}
    if writer is not None:
        path = writer.finalize()
        print(f"wrote {path}")
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    evaluation(parse_args())
