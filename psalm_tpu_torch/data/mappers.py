"""Image preprocessing of the chat path (host side, numpy and PIL).

Counterpart of ``psalm_tpu/data/mappers.py``'s ``resize_shortest_edge_shape``
and ``ImageMapper.transform_image``: the reference's
ResizeShortestEdge(S, max_size=S) + FixedSizeCrop(S x S), which for
max_size == short edge is "scale the longest side to S, pad bottom-right
with 128", then ImageNet mean/std normalization and a padding mask. PIL is
imported where it is used, so the module imports without it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

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


@dataclasses.dataclass
class ProcessedImage:
    image: np.ndarray          # [S, S, 3] float32 normalized
    padding_mask: np.ndarray   # [S, S] bool, True where padded
    resized_hw: Tuple[int, int]
    original_hw: Tuple[int, int]
    scale: float


class ImageMapper:
    """The deterministic eval mapper (the reference uses the same transforms
    for its shipped recipe)."""

    def __init__(self, image_size: int = 1024):
        self.image_size = image_size

    def transform_image(self, image: np.ndarray) -> ProcessedImage:
        from PIL import Image
        h, w = image.shape[:2]
        S = self.image_size
        nh, nw = resize_shortest_edge_shape(h, w, S, S)
        pil = Image.fromarray(image.astype(np.uint8))
        resized = np.asarray(pil.resize((nw, nh), Image.BILINEAR))

        canvas = np.full((S, S, 3), 128, np.uint8)  # d2 pad_value default
        canvas[:nh, :nw] = resized
        padding_mask = np.ones((S, S), bool)
        padding_mask[:nh, :nw] = False

        image_out = (canvas.astype(np.float32) - PIXEL_MEAN) / PIXEL_STD
        return ProcessedImage(image=image_out, padding_mask=padding_mask,
                              resized_hw=(nh, nw), original_hw=(h, w),
                              scale=nh / h)
