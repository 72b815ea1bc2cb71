"""DAVIS-2017 video object segmentation evaluation CLI.

Counterpart of ``psalm_tpu/eval/eval_davis.py`` (behavioral spec:
psalm/eval/eval_davis.py), with the same flags, prints and output layout:
semi-supervised VOS with a mask-propagation memory. The first frame's
ground-truth masks are the visual prompts (region points, with the first
frame as ``vp_images``); each frame's picked masks become the next frame's
prompts unless two of them overlap with IoU > 0.4 or one is empty
(:461-470); each object takes its best query among the top 10 that no
earlier object took (:443-455); every frame is written as an indexed PNG
with each object's fill number (the DAVIS instance value). J&F is computed
offline by the official toolkit on the written PNGs.

``--with_memory`` is parsed by ``str2bool``: JAX's ``type=bool`` reads
``--with_memory False`` as true. ``evaluation(args, cfg, tokenizer, model)``
takes an injected port model or loads ``--model_path`` on the card
(``runner.load_eval_model``); it returns the printed summary and, per
frame, whether the memory gave its prompts.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from psalm_tpu_torch.config import PSALMConfig, SegTask
from psalm_tpu_torch.data import coco_rle
from psalm_tpu_torch.data.datasets import DataConfig
from psalm_tpu_torch.data.mappers import ImageMapper
from psalm_tpu_torch.data.splicer import splice, stack_samples
from psalm_tpu_torch.data.tokenization import (build_conversation,
                                               interactive_prompt,
                                               tokenize_conversation)
from psalm_tpu_torch.eval.runner import EvalRunner, load_eval_model
from psalm_tpu_torch.train.train import str2bool


def davis_palette() -> bytes:
    """The DAVIS-2017 256-entry palette (PASCAL VOC colormap). Saving with
    an explicit palette is required for correctness: PIL optimizes bare
    P-mode PNGs and remaps sparse palette indices (fills {0, 2} become
    {0, 1}), which would corrupt the object ids the toolkit reads back."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, v = i, np.zeros(3, np.uint8)
        for j in range(8):
            v[0] |= ((c >> 0) & 1) << (7 - j)
            v[1] |= ((c >> 1) & 1) << (7 - j)
            v[2] |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = v
    return pal.reshape(-1).tobytes()


def save_indexed_png(path: str, arr: np.ndarray) -> None:
    img = Image.fromarray(arr.astype(np.uint8), mode="P")
    img.putpalette(davis_palette())
    img.save(path)


def fuse_davis_mask(mask_list, fill_numbers, shape):
    fused = np.zeros(shape, np.uint8)
    for mask, fill in zip(mask_list, fill_numbers):
        fused[mask.astype(bool)] = int(fill)
    return fused


class DavisFrameBuilder:
    """Builds a region-task batch for one frame from visual-prompt masks (in
    the original frame geometry), sampled as region points from one
    generator that advances frame after frame."""

    def __init__(self, tokenizer, dcfg: DataConfig):
        self.tokenizer = tokenizer
        self.dcfg = dcfg
        self.mapper = ImageMapper(dcfg.image_size, dcfg.device_normalize)
        self.rng = np.random.default_rng(dcfg.seed)

    def build(self, image: np.ndarray, vp_image: np.ndarray,
              vp_masks: List[np.ndarray]) -> Dict[str, np.ndarray]:
        proc = self.mapper.transform_image(image)
        vp_proc = self.mapper.transform_image(vp_image)
        R = len(vp_masks)
        Rmax = self.dcfg.max_regions
        pts = np.zeros((Rmax, self.dcfg.num_region_points, 2), np.float32)
        valid = np.zeros((Rmax,), bool)
        for i, m in enumerate(vp_masks[:Rmax]):
            tm = self.mapper.transform_mask(m.astype(np.uint8))
            pts[i] = ImageMapper.sample_region_points(
                tm, self.dcfg.num_region_points, self.rng)
            valid[i] = True

        human, gpt = interactive_prompt(max(R, 1))
        input_ids, _ = tokenize_conversation(build_conversation(human, gpt),
                                             self.tokenizer)
        s = splice(input_ids, None,
                   num_image_tokens=self.dcfg.num_image_tokens,
                   num_seg_queries=self.dcfg.num_seg_queries,
                   pad_len=self.dcfg.pad_len, num_regions=max(R, 1))
        batch = stack_samples([s])
        batch["images"] = proc.image[None]
        batch["vp_images"] = vp_proc.image[None]
        batch["padding_mask"] = proc.padding_mask[None]
        batch["region_points"] = pts[None]
        batch["region_valid"] = valid[None]
        batch["resized_hw"] = np.asarray(proc.resized_hw)[None]
        batch["original_hw"] = np.asarray(proc.original_hw)[None]
        return batch, proc


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--json_path", required=True, help="*_val_psalm.json")
    p.add_argument("--image_folder", required=True, help="DAVIS root")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--with_memory", type=str2bool, default=True)
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--limit", type=int, default=0)
    return p.parse_args(argv)


def _read_rgb(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def _memory_holds(pred_masks: List[np.ndarray]) -> bool:
    """The masks may prompt the next frame: no two overlap with IoU > 0.4
    and none is empty."""
    for i in range(len(pred_masks)):
        for j in range(i + 1, len(pred_masks)):
            inter = np.logical_and(pred_masks[i], pred_masks[j]).sum()
            union = np.logical_or(pred_masks[i], pred_masks[j]).sum()
            if union and inter / union > 0.4:
                return False
    return all(m.sum() > 0 for m in pred_masks)


def evaluation(args, cfg=None, tokenizer=None, model=None):
    if model is None:
        tokenizer, model, cfg = load_eval_model(args.model_path,
                                                SegTask.REGION, cfg)
    cfg = cfg or PSALMConfig(seg_task=SegTask.REGION)
    with open(args.json_path) as f:
        data = json.load(f)

    dcfg = DataConfig(image_size=cfg.image_size,
                      num_image_tokens=(cfg.image_size // 64) ** 2,
                      num_seg_queries=cfg.mask_decoder.num_queries,
                      pad_len=args.model_max_length)
    builder = DavisFrameBuilder(tokenizer, dcfg)
    runner = EvalRunner(model, cfg)

    prev_video: Optional[str] = None
    prev_masks: List[np.ndarray] = []
    prev_fills: List[int] = []
    prev_image: Optional[np.ndarray] = None
    memory: List[bool] = []  # per frame: did the memory give the prompts

    n = min(len(data), args.limit) if args.limit else len(data)
    t0 = time.time()
    for idx in range(n):
        rec = data[idx]
        video = rec["image"].split("/")[-2]
        image = _read_rgb(os.path.join(args.image_folder, rec["image"]))
        H, W = image.shape[:2]

        first_anns = rec["first_frame_anns"]
        first_fills = [int(a["category_id"]) for a in first_anns]
        first_masks = [coco_rle.decode(a["segmentation"]) for a in first_anns]
        first_image = _read_rgb(os.path.join(args.image_folder,
                                             rec["first_frame_image"]))

        if prev_video != video:
            prev_video = video
            prev_masks, prev_fills, prev_image = [], [], None

        use_memory = bool(args.with_memory and prev_masks
                          and len(prev_fills) == len(first_fills))
        memory.append(use_memory)
        if use_memory:
            vp_masks, fills, vp_image = prev_masks, prev_fills, prev_image
        else:
            vp_masks, fills, vp_image = first_masks, first_fills, first_image

        batch, _ = builder.build(image, vp_image, vp_masks)
        out = runner.infer(batch)
        scores = out["region"]["scores"][0].T  # [R, Q]
        masks = out["region"]["masks"][0]  # [Q, H, W], the original size

        pred_masks, fill_list = [], []
        taken: List[int] = []
        for r in range(len(fills)):
            order = np.argsort(-scores[r])[:10]
            pick = next((int(q) for q in order if int(q) not in taken),
                        int(order[0]))
            taken.append(pick)
            pred_masks.append(masks[pick].astype(np.uint8))
            fill_list.append(fills[r])

        fused = fuse_davis_mask(pred_masks, fill_list, (H, W))
        out_path = os.path.join(args.output_dir, video)
        os.makedirs(out_path, exist_ok=True)
        frame_name = os.path.splitext(os.path.basename(rec["image"]))[0]
        save_indexed_png(os.path.join(out_path, frame_name + ".png"), fused)

        if args.with_memory and _memory_holds(pred_masks):
            prev_masks = [m.astype(np.uint8) for m in pred_masks]
            prev_fills = fill_list
            prev_image = image

    summary = {"frames": n, "fps": n / (time.time() - t0),
               "output_dir": args.output_dir}
    print(json.dumps(summary))
    return {**summary, "memory": memory}


if __name__ == "__main__":
    evaluation(parse_args())
