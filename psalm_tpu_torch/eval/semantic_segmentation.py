"""Open-vocabulary / generic semantic segmentation evaluation CLI.

Behavioral spec: psalm/eval/semantic_segmentation.py — a generic dataset of
(image, label-PNG) pairs with a class-name list (the OV_SEM_DICT registry of
ADE-150 / PC-59 / PC-459 / PASCAL-VOC-20, :247-292), per-image class-name
subsampling to at most --num_class names with random negatives (:343-356),
the panoptic-style candidate-category prompt, and mIoU via histogram
intersection/union. Dataset paths/class lists are file-driven here instead
of hard-coded tables: pass --class_names (txt, one per line; 'background' is
appended automatically).

Counterpart of ``psalm_tpu/eval/semantic_segmentation.py``, with the same flags
and result keys. ``evaluation(args, cfg, tokenizer, model)`` takes an
injected port model (the weights live in it) or loads ``--model_path``
on the card (``runner.load_eval_model``); the device is the model's.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from typing import List

import numpy as np
from PIL import Image

from psalm_tpu_torch.config import PSALMConfig, SegTask
from psalm_tpu_torch.data.datasets import BaseTaskDataset, DataConfig, collate
from psalm_tpu_torch.data.splicer import splice
from psalm_tpu_torch.data.tokenization import (build_conversation, panoptic_prompt,
                                         tokenize_class_names,
                                         tokenize_conversation)
from psalm_tpu_torch.eval.metrics import SemSegMeter
from psalm_tpu_torch.eval.runner import EvalRunner, load_eval_model


class CommonSemanticDataset(BaseTaskDataset):
    """(image, label) pairs + class names; emits a panoptic-style prompt over
    a per-image subsampled class list (gt classes + random negatives)."""

    dataset_type = "semantic"

    def __init__(self, list_path, image_folder, label_folder, class_names,
                 tokenizer, cfg: DataConfig, num_class: int = 0,
                 ignore_label: int = 255, seed: int = 0):
        with open(list_path) as f:
            if list_path.endswith(".json"):
                self.data = json.load(f)
            else:
                self.data = [{"image": l.split()[0],
                              "label": l.split()[1] if len(l.split()) > 1 else
                              l.split()[0].replace(".jpg", ".png")}
                             for l in f.read().splitlines() if l.strip()]
        self.image_folder = image_folder
        self.label_folder = label_folder
        self.ignore_label = ignore_label
        self.num_class = num_class
        self.pyrng = random.Random(seed)
        super().__init__(tokenizer, cfg,
                         class_names=list(class_names) + ["background"],
                         is_train=False)

    def __getitem__(self, idx):
        rec = self.data[idx]
        image = self._load_image(os.path.join(self.image_folder, rec["image"]))
        proc = self.mapper.transform_image(image)
        label = np.asarray(Image.open(
            os.path.join(self.label_folder, rec["label"])))

        gt_classes = np.unique(label)
        gt_classes = gt_classes[gt_classes != self.ignore_label]
        all_names = self.coco_class_name[:-1]
        if self.num_class and len(all_names) > self.num_class:
            # subsample: gt classes + random negatives (reference :343-356).
            # K is held constant at num_class so the jitted program doesn't
            # recompile per image (gt classes beyond num_class are dropped
            # from the prompt; they score as misses, as in the reference).
            chosen = sorted(set(int(c) for c in gt_classes
                                if c < len(all_names)))[:self.num_class]
            negatives = [i for i in range(len(all_names)) if i not in chosen]
            self.pyrng.shuffle(negatives)
            chosen = sorted(chosen + negatives[:self.num_class - len(chosen)])
        else:
            chosen = list(range(len(all_names)))
        names = [all_names[i] for i in chosen] + ["background"]
        # remap ids: original class -> position in `names`
        remap = {c: i for i, c in enumerate(chosen)}

        K = len(names)
        human, gpt = panoptic_prompt(K, task_name="Semantic Segmentation")
        prompt = build_conversation(human, gpt)
        input_ids, _ = tokenize_conversation(prompt, self.tokenizer)
        cls_ids, cls_idx = tokenize_class_names(names, self.tokenizer)
        s = splice(input_ids, None,
                   num_image_tokens=self.cfg.num_image_tokens,
                   num_seg_queries=self.cfg.num_seg_queries,
                   pad_len=self.cfg.pad_len, class_name_ids=cls_ids,
                   cls_indices=cls_idx)
        return {**s.as_dict(), "images": proc.image,
                "padding_mask": proc.padding_mask,
                "resized_hw": np.asarray(proc.resized_hw),
                "original_hw": np.asarray(proc.original_hw),
                "label": label, "chosen": np.asarray(chosen),
                "num_class_names": K, "dataset_type": self.dataset_type,
                "file_name": rec["image"],
                "image_id": idx}


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--list_path", required=True)
    p.add_argument("--image_folder", required=True)
    p.add_argument("--label_folder", required=True)
    p.add_argument("--class_names", required=True, help="txt, one name/line")
    p.add_argument("--num_class", type=int, default=0,
                   help="subsample class list per image (OV eval)")
    p.add_argument("--ignore_label", type=int, default=255)
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
                                                SegTask.SEMANTIC, cfg)
    cfg = cfg or PSALMConfig(seg_task=SegTask.SEMANTIC)
    with open(args.class_names) as f:
        class_names = [l.strip() for l in f if l.strip()]

    dcfg = DataConfig(image_size=cfg.image_size,
                      num_image_tokens=(cfg.image_size // 64) ** 2,
                      num_seg_queries=cfg.mask_decoder.num_queries,
                      pad_len=args.model_max_length)
    ds = CommonSemanticDataset(args.list_path, args.image_folder,
                               args.label_folder, class_names, tokenizer, dcfg,
                               num_class=args.num_class,
                               ignore_label=args.ignore_label)
    meter = SemSegMeter(len(class_names), args.ignore_label)
    writer = None
    if getattr(args, "output_dir", None):
        from psalm_tpu_torch.eval.artifacts import SemSegPredictionWriter
        writer = SemSegPredictionWriter(args.output_dir)

    n = min(len(ds), args.limit) if args.limit else len(ds)
    runner_cache = {}
    t0 = time.time()
    for i in range(n):
        s = ds[i]
        K = int(s["num_class_names"])
        if K not in runner_cache:
            runner_cache[K] = EvalRunner(model, cfg,
                                         num_class_names=K)
        runner = runner_cache[K]
        batch = collate([s], seq_bucket=getattr(args, "seq_bucket", 128))
        out = runner.infer({k: v for k, v in batch.items()
                            if k not in ("label", "chosen")})
        # runner returns the argmax id map already at original resolution
        # (head at padded res -> bilinear restore -> argmax, the reference's
        # sem_seg_postprocess_before_inference=False order)
        sem = np.asarray(out["sem_seg"][0], np.int32)
        # map subsampled positions back to original class ids
        chosen = s["chosen"]
        sem_full = chosen[np.clip(sem, 0, len(chosen) - 1)]
        meter.update(sem_full, s["label"])
        if writer is not None:
            writer.add(s["file_name"], sem_full)
        if i % 100 == 0:
            print(f"[{i}/{n}] {meter.summarize()}")

    results = {"semantic": meter.summarize(),
               "images_per_sec": n / (time.time() - t0)}
    if writer is not None:
        print(f"wrote {writer.finalize()}")
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    evaluation(parse_args())
