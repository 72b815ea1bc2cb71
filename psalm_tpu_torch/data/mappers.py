"""Image preprocessing mappers (host side, numpy, PIL and OpenCV).

Counterpart of ``psalm_tpu/data/mappers.py`` (held equal by
``tests/test_torch_copies.py`` and ``tests/test_torch_data.py``).
Behavioral spec: the detectron2-transform pipeline of the reference mappers
(coco_panoptic_mapper.py:85-199, coco_instance_mapper.py, coco_semantic_
mapper.py): ResizeShortestEdge(1024, max_size=1024) + FixedSizeCrop(1024x1024)
— which for max_size==short_edge degenerates to "scale longest side to 1024,
pad bottom-right" (image pad value 128, segmentation pad value 0) — then
ImageNet mean/std normalization and a padding_mask marking padded pixels.

Visual-prompt handling for interactive segmentation reproduces
coco_instance_mapper.py:233-298: RLE decode, circle dilation of point (r=10)
and scribble (r=5) prompts via enhance_with_circles
(coco_panoptic_mapper.py:17-33).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from psalm_tpu_torch.data import coco_rle

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def resize_shortest_edge_shape(h: int, w: int, short: int, max_size: int
                               ) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge.get_output_shape."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    newh = int(h * scale + 0.5)
    neww = int(w * scale + 0.5)
    return newh, neww


def draw_circles(mask: np.ndarray, radius: int) -> np.ndarray:
    """enhance_with_circles (coco_panoptic_mapper.py:17-33): dilate each
    foreground pixel into a disc of the given radius."""
    import cv2
    mask = np.asarray(mask, np.uint8)
    kernel_size = 2 * radius + 1
    ys, xs = np.mgrid[:kernel_size, :kernel_size] - radius
    kernel = ((ys ** 2 + xs ** 2) <= radius ** 2).astype(np.uint8)
    return cv2.dilate(mask, kernel)


@dataclasses.dataclass
class ProcessedImage:
    image: np.ndarray          # [S, S, 3] float32 normalized
    padding_mask: np.ndarray   # [S, S] bool, True where padded
    resized_hw: Tuple[int, int]
    original_hw: Tuple[int, int]
    scale: float


class ImageMapper:
    """Deterministic eval-parity mapper; training augmentation hooks can be
    layered on top (the reference uses the same deterministic transforms for
    its shipped recipe — build_transform_gen == build_transform_gen_for_eval)."""

    def __init__(self, image_size: int = 1024, device_normalize: bool = False):
        self.image_size = image_size
        # device_normalize: emit the raw uint8 canvas and let the model
        # normalize on device (PSALM.encode_images) — 4x less host->device
        # traffic; identical math (the PIL resize output is integer-valued)
        self.device_normalize = device_normalize

    def transform_image(self, image: np.ndarray) -> ProcessedImage:
        h, w = image.shape[:2]
        S = self.image_size
        nh, nw = resize_shortest_edge_shape(h, w, S, S)
        pil = Image.fromarray(image.astype(np.uint8))
        resized = np.asarray(pil.resize((nw, nh), Image.BILINEAR))

        canvas = np.full((S, S, 3), 128, np.uint8)  # d2 pad_value default
        canvas[:nh, :nw] = resized
        padding_mask = np.ones((S, S), bool)
        padding_mask[:nh, :nw] = False

        image_out = (canvas if self.device_normalize
                     else (canvas.astype(np.float32) - PIXEL_MEAN) / PIXEL_STD)
        return ProcessedImage(image=image_out, padding_mask=padding_mask,
                              resized_hw=(nh, nw), original_hw=(h, w),
                              scale=nh / h)

    def transform_mask(self, mask: np.ndarray, interp=Image.NEAREST
                       ) -> np.ndarray:
        """Apply the same geometry to a segmentation map; pad value 0."""
        h, w = mask.shape[:2]
        S = self.image_size
        nh, nw = resize_shortest_edge_shape(h, w, S, S)
        pil = Image.fromarray(mask)
        resized = np.asarray(pil.resize((nw, nh), interp))
        out = np.zeros((S, S) + mask.shape[2:], mask.dtype)
        out[:nh, :nw] = resized
        return out

    # -- task-specific ------------------------------------------------------

    def panoptic_targets(self, pan_seg_rgb: np.ndarray,
                         segments_info: Sequence[Dict]) -> Dict:
        """Rasterize a panoptic PNG into per-segment bitmasks
        (coco_panoptic_mapper.py:166-199)."""
        pan = self.transform_mask(pan_seg_rgb)
        pan_id = coco_rle.rgb2id(pan)
        classes, masks = [], []
        for seg in segments_info:
            if not seg.get("iscrowd", 0):
                classes.append(seg["category_id"])
                masks.append(pan_id == seg["id"])
        S = self.image_size
        if masks:
            # uint8: binary masks at 1024^2 x 100 per sample are the
            # dominant host->device train traffic; the criterion casts on
            # device (targets["masks"].astype(f32))
            gt_masks = np.stack(masks).astype(np.uint8)
        else:
            gt_masks = np.zeros((0, S, S), np.uint8)
        return {"gt_classes": np.asarray(classes, np.int64),
                "gt_masks": gt_masks}

    def instance_targets(self, annotations: Sequence[Dict],
                         original_hw: Tuple[int, int]) -> Dict:
        """Decode polygon/RLE instance annotations and transform them."""
        h, w = original_hw
        classes, masks = [], []
        for ann in annotations:
            if ann.get("iscrowd", 0):
                continue
            seg = ann["segmentation"]
            if isinstance(seg, dict):
                m = coco_rle.decode(seg)
            else:
                m = coco_rle.merge_polygons_to_mask(seg, h, w)
            classes.append(ann["category_id"])
            masks.append(self.transform_mask(m))
        S = self.image_size
        gt_masks = (np.stack(masks).astype(np.uint8) if masks
                    else np.zeros((0, S, S), np.uint8))
        return {"gt_classes": np.asarray(classes, np.int64),
                "gt_masks": gt_masks}

    def visual_prompts(self, annotations: Sequence[Dict],
                       region_mask_type: str) -> List[np.ndarray]:
        """Decode and dilate visual-prompt RLEs
        (coco_instance_mapper.py:233-251): point r=10, scribble r=5."""
        out = []
        for ann in annotations:
            rle = ann.get(region_mask_type)
            if rle is None:
                continue
            m = coco_rle.decode(rle)
            if region_mask_type == "point_visual_prompt_mask":
                m = draw_circles(m, 10)
            elif region_mask_type == "scribble_visual_prompt_mask":
                m = draw_circles(m, 5)
            out.append(m)
        return out

    @staticmethod
    def sample_region_points(mask: np.ndarray, num_points: int,
                             rng: np.random.Generator) -> np.ndarray:
        """Sample in-mask pixel coordinates with repeat, normalized to the
        ORIGINAL mask frame, as (x, y) in [0,1] — rand_sample_repeat +
        nonzero()/wh + flip (context_cluster.py:31-40, :351-363)."""
        ys, xs = np.nonzero(mask)
        n = len(ys)
        if n == 0:
            return np.zeros((num_points, 2), np.float32)
        if n < num_points:
            extra = rng.integers(0, n, num_points - n)
            idx = np.concatenate([np.arange(n), extra])
        else:
            idx = rng.permutation(n)[:num_points]
        h, w = mask.shape
        pts = np.stack([xs[idx] / w, ys[idx] / h], axis=-1)
        return pts.astype(np.float32)
