"""COCO panoptic evaluation CLI (reference:
psalm/eval/panoptic_segmentation.py — same flags, PQ + mIoU metrics).

Usage:
  python -m psalm_tpu_torch.eval.panoptic_segmentation \
      --model_path /path/to/PSALM --json_path /path/to/coco

Counterpart of ``psalm_tpu/eval/panoptic_segmentation.py``, with the same flags
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
from psalm_tpu_torch.data.datasets import DataConfig, PanopticDataset, collate
from psalm_tpu_torch.eval.metrics import PQStat, SemSegMeter
from psalm_tpu_torch.eval.runner import EvalRunner, load_eval_model


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--json_path", required=True,
                   help="COCO root with val2017/ panoptic_val2017/ annotations/")
    p.add_argument("--image_folder", default=None)
    p.add_argument("--eval_batch_size", type=int, default=1)
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--seq_bucket", type=int, default=128,
                   help="pad token sequences to the batch max rounded up "
                        "to this multiple instead of model_max_length "
                        "(0 = fixed pad; outputs identical either way)")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--limit", type=int, default=0, help="eval first N images")
    return p.parse_args()


def evaluation(args, cfg=None, tokenizer=None, model=None):
    if model is None:
        tokenizer, model, cfg = load_eval_model(args.model_path,
                                                SegTask.PANOPTIC, cfg)
    cfg = cfg or PSALMConfig(seg_task=SegTask.PANOPTIC)

    dcfg = DataConfig(image_size=cfg.image_size,
                      num_image_tokens=(cfg.image_size // 64) ** 2,
                      num_seg_queries=cfg.mask_decoder.num_queries,
                      pad_len=args.model_max_length)
    ds = PanopticDataset(args.json_path, tokenizer, dcfg, is_train=False)
    K = len(ds.coco_class_name)
    from psalm_tpu_torch.eval.runner import bucket_for_sizes
    bucket = bucket_for_sizes(ds.image_sizes) if ds.image_sizes else None
    runner = EvalRunner(model, cfg, num_class_names=K,
                        is_thing=ds.is_thing + [False], bucket_hw=bucket)

    pq_stat = PQStat()
    sem_meter = SemSegMeter(num_classes=K - 1)
    writer = None
    if args.output_dir:
        from psalm_tpu_torch.eval.artifacts import PanopticPredictionWriter
        cont_to_dataset = {v: k for k, v in ds.coco_id_to_cont_id.items()}
        writer = PanopticPredictionWriter(
            f"{args.output_dir}/panoptic_preds", cont_to_dataset)
    n = min(len(ds), args.limit) if args.limit else len(ds)
    t0 = time.time()

    from psalm_tpu_torch.eval.runner import Prefetcher

    def batches():
        for i in range(0, n, args.eval_batch_size):
            samples = [ds[j]
                       for j in range(i, min(i + args.eval_batch_size, n))]
            batch = collate(samples, seq_bucket=getattr(args, "seq_bucket", 128))
            # upload on the prefetch thread: it overlaps the previous
            # batch's inference and metrics
            yield i, samples, batch, runner.stage(batch)

    for i, samples, batch, staged in Prefetcher(batches(), depth=2):
        out = runner.infer(batch, staged=staged)
        for b, s in enumerate(samples):
            rh, ow = s["resized_hw"], s["original_hw"]
            # predictions come back at original resolution (crop-then-head)
            pan = out["panoptic_seg"][b]
            seg_info = out["segments"]
            pred_segments = [
                {"id": int(seg_info["id"][b][q]),
                 "category_id": int(seg_info["category"][b][q]),
                 "isthing": bool(seg_info["isthing"][b][q])}
                for q in range(len(seg_info["id"][b]))
                if seg_info["valid"][b][q]]
            if writer is not None:
                writer.add(int(s["image_id"]), s["file_name"], pan,
                           pred_segments)

            # gt from padded masks -> restore to original frame
            gt_map = np.zeros_like(pan)
            gt_segments = []
            for gi in range(int(s["gt_valid"].sum())):
                m = EvalRunner.restore_map(
                    s["gt_masks"][gi].astype(np.uint8), rh, ow).astype(bool)
                gt_map[m] = gi + 1
                gt_segments.append({"id": gi + 1,
                                    "category_id": int(s["gt_labels"][gi])})
            pq_stat.update(pan, pred_segments, gt_map, gt_segments)

            sem = out["sem_seg"][b]
            gt_sem = np.full(tuple(ow), 255, np.int32)
            for gi in range(int(s["gt_valid"].sum())):
                m = EvalRunner.restore_map(
                    s["gt_masks"][gi].astype(np.uint8), rh, ow).astype(bool)
                gt_sem[m] = int(s["gt_labels"][gi])
            sem_meter.update(sem, gt_sem)
        if i % 50 == 0:
            print(f"[{i}/{n}] {(i + len(samples)) / (time.time() - t0):.2f} img/s")

    cats = {i: {"isthing": t} for i, t in enumerate(ds.is_thing)}
    results = {"panoptic": pq_stat.summarize(cats),
               "semantic": sem_meter.summarize(),
               "images_per_sec": n / (time.time() - t0)}

    if writer is not None:
        import os
        pred_json = writer.finalize()
        print(f"wrote official-format artifacts: {pred_json}")
        # score against the OFFICIAL GT json + PNGs (the reference's
        # panopticapi pq_compute path, panoptic_evaluation.py:36-147) —
        # independent of the self-restored-GT numbers above
        split = "val2017"
        gt_json = os.path.join(ds.root, f"annotations/panoptic_{split}.json")
        gt_png_dir = ds.pan_gt_path
        if os.path.exists(gt_json) and os.path.isdir(gt_png_dir):
            from psalm_tpu_torch.eval.artifacts import (
                score_panoptic_against_official_gt)
            official = PQStat()
            score_panoptic_against_official_gt(
                official, writer.output_dir, gt_json, gt_png_dir,
                ds.coco_id_to_cont_id)
            results["panoptic_official_gt"] = official.summarize(cats)

    print(json.dumps(results, indent=2))
    if args.output_dir:
        import os
        os.makedirs(args.output_dir, exist_ok=True)
        with open(f"{args.output_dir}/panoptic_results.json", "w") as f:
            json.dump(results, f)
    return results


if __name__ == "__main__":
    evaluation(parse_args())
