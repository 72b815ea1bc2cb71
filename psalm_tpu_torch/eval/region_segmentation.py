"""COCO-Interactive (visual-prompt) evaluation CLI (reference:
psalm/eval/region_segmentation.py — cIoU/gIoU per prompt type).

--region_mask_type selects point/box/scribble/mask visual prompts
(docs/GETTING_STARTED.md:37-38).

Counterpart of ``psalm_tpu/eval/region_segmentation.py``, with the same flags
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
from psalm_tpu_torch.data.datasets import DataConfig, InteractiveDataset, collate
from psalm_tpu_torch.eval.metrics import IoUMeter
from psalm_tpu_torch.eval.runner import EvalRunner, load_eval_model


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--json_path", required=True)
    p.add_argument("--image_folder", required=True)
    p.add_argument("--region_mask_type", default="point_visual_prompt_mask",
                   choices=["point_visual_prompt_mask", "mask_visual_prompt_mask",
                            "box_visual_prompt_mask", "scribble_visual_prompt_mask"])
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
                                                SegTask.REGION, cfg)
    cfg = cfg or PSALMConfig(seg_task=SegTask.REGION)

    dcfg = DataConfig(image_size=cfg.image_size,
                      num_image_tokens=(cfg.image_size // 64) ** 2,
                      num_seg_queries=cfg.mask_decoder.num_queries,
                      pad_len=args.model_max_length)
    ds = InteractiveDataset(args.json_path, args.image_folder, tokenizer, dcfg,
                            is_train=False,
                            region_mask_type=args.region_mask_type)
    from psalm_tpu_torch.eval.runner import bucket_for_sizes
    bucket = (bucket_for_sizes(ds.image_sizes)
              if getattr(ds, 'image_sizes', None) else None)
    runner = EvalRunner(model, cfg, bucket_hw=bucket)
    meter = IoUMeter()
    pred_writer = None
    if args.output_dir:
        from psalm_tpu_torch.eval.artifacts import RegionPredictionWriter
        pred_writer = RegionPredictionWriter(args.output_dir,
                                             args.region_mask_type)

    n = min(len(ds), args.limit) if args.limit else len(ds)
    t0 = time.time()
    for i in range(0, n, args.eval_batch_size):
        samples = [ds[j] for j in range(i, min(i + args.eval_batch_size, n))]
        batch = collate(samples, seq_bucket=getattr(args, "seq_bucket", 128))
        out = runner.infer(batch)
        reg = out["region"]
        for b, s in enumerate(samples):
            rh, ow = s["resized_hw"], s["original_hw"]
            n_reg = int(s["region_valid"].sum())
            preds, gts = [], []
            for r in range(min(n_reg, int(s["gt_valid"].sum()))):
                # best query per region prompt (region_inference scores [Q, R])
                top = int(np.argmax(reg["scores"][b][:, r]))
                pred = reg["masks"][b][top].astype(bool)  # original res
                # the reference bilinearly restores gt (sem_seg_postprocess,
                # llava_phi.py:1461-1464) then TRUNCATES to uint8
                # (region eval parse_outputs: .astype(np.uint8)) — only
                # exactly-1.0 pixels survive, eroding mask boundaries;
                # reproduced for score parity
                gt = EvalRunner.restore_map(
                    s["gt_masks"][r].astype(np.float32), rh, ow,
                    nearest=False).astype(np.uint8).astype(bool)
                meter.update(pred, gt)
                preds.append(pred)
                gts.append(gt)
            if pred_writer is not None:
                pred_writer.add(s["file_name"], preds, gts)
        if i % 100 == 0:
            print(f"[{i}/{n}] cIoU={meter.ciou:.2f} gIoU={meter.giou:.2f}")

    results = {"region": {"cIoU": meter.ciou, "gIoU": meter.giou,
                          "type": args.region_mask_type},
               "images_per_sec": n / (time.time() - t0)}
    if args.output_dir:
        # reference artifacts: RLE pred/gt pickle + metric txt
        # (region_segmentation.py:282-297)
        from psalm_tpu_torch.eval.artifacts import write_metric_txt
        msg = ("benchmark: {}: giou: {:.4f}, ciou: {:.4f}"
               .format(args.region_mask_type, meter.giou / 100,
                       meter.ciou / 100))
        write_metric_txt(args.output_dir, args.region_mask_type, msg)
        path = pred_writer.finalize()
        print(f"wrote {path}")
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    evaluation(parse_args())
