"""gRefCOCO (generalized referring, incl. no-target) evaluation CLI.

Behavioral spec: psalm/eval/eval_grefcoco.py — union-fuse all masks whose
referring score exceeds --thr (0.6, fuse_masks :277-285); if none exceed,
fall back to the top-1 mask; gIoU counts no-target samples as IoU 1 when the
prediction is empty (union==0 -> acc_iou 1, compute_metric :141-188);
cIoU from the cumulative foreground intersection/union.

Counterpart of ``psalm_tpu/eval/eval_grefcoco.py``, with the same flags
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
from psalm_tpu_torch.data.datasets import DataConfig, ReferringDataset, collate
from psalm_tpu_torch.eval.runner import EvalRunner, load_eval_model


def fuse_masks(masks):
    fused = None
    for m in masks:
        fused = m if fused is None else np.logical_or(fused, m)
    return fused


class GRefCOCOMeter:
    """Foreground cIoU + gIoU with the no-target convention."""

    def __init__(self):
        self.inter = 0.0
        self.union = 0.0
        self.accs = []

    def update(self, pred: np.ndarray, gt: np.ndarray):
        pred = np.asarray(pred, bool)
        gt = np.asarray(gt, bool)
        i = float(np.logical_and(pred, gt).sum())
        u = float(np.logical_or(pred, gt).sum())
        self.inter += i
        self.union += u
        self.accs.append(1.0 if u == 0 else i / u)

    @property
    def ciou(self):
        return 100 * self.inter / self.union if self.union else 0.0

    @property
    def giou(self):
        return 100 * float(np.mean(self.accs)) if self.accs else 0.0


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--json_path", required=True)
    p.add_argument("--image_folder", required=True)
    p.add_argument("--thr", type=float, default=0.6)
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
                                                SegTask.REFERRING, cfg)
    cfg = cfg or PSALMConfig(seg_task=SegTask.REFERRING)

    dcfg = DataConfig(image_size=cfg.image_size,
                      num_image_tokens=(cfg.image_size // 64) ** 2,
                      num_seg_queries=cfg.mask_decoder.num_queries,
                      pad_len=args.model_max_length)
    ds = ReferringDataset(args.json_path, args.image_folder, tokenizer, dcfg,
                          is_train=False)
    from psalm_tpu_torch.eval.runner import bucket_for_sizes
    bucket = (bucket_for_sizes(ds.image_sizes)
              if getattr(ds, 'image_sizes', None) else None)
    runner = EvalRunner(model, cfg, bucket_hw=bucket)
    meter = GRefCOCOMeter()
    pred_writer = None
    if getattr(args, "output_dir", None):
        from psalm_tpu_torch.eval.artifacts import RegionPredictionWriter
        pred_writer = RegionPredictionWriter(args.output_dir, "grefcoco")

    n = min(len(ds), args.limit) if args.limit else len(ds)
    t0 = time.time()
    for i in range(n):
        s = ds[i]
        batch = collate([s], seq_bucket=getattr(args, "seq_bucket", 128))
        out = runner.infer(batch)
        ref = out["referring"]
        masks = ref["masks"][0]
        scores = ref["scores"][0]
        over = [masks[q] for q in range(len(scores)) if scores[q] > args.thr]
        fused = fuse_masks(over)
        if fused is None:
            fused = masks[int(np.argmax(scores))]
        pred = np.asarray(fused, bool)  # already at original resolution

        # gt decoded at the original (H, W) (reference eval_grefcoco gt path)
        gt = ds.original_gt_mask(i)
        meter.update(pred, gt)
        if pred_writer is not None:
            pred_writer.add(s["file_name"], [pred], [gt])
        if i % 100 == 0:
            print(f"[{i}/{n}] cIoU={meter.ciou:.2f} gIoU={meter.giou:.2f}")

    results = {"grefcoco": {"cIoU": meter.ciou, "gIoU": meter.giou,
                            "thr": args.thr},
               "images_per_sec": n / (time.time() - t0)}
    if pred_writer is not None:
        # reference artifacts (eval_grefcoco.py tail): pkl + thr-suffixed txt
        from psalm_tpu_torch.eval.artifacts import write_metric_txt
        msg = ("benchmark: grefcoco: thr {}, giou: {:.4f}, ciou: {:.4f}"
               .format(args.thr, meter.giou / 100, meter.ciou / 100))
        write_metric_txt(args.output_dir, f"grefcoco_{int(args.thr * 10)}",
                         msg)
        print(f"wrote {pred_writer.finalize()}")
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    evaluation(parse_args())
