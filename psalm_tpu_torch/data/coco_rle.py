"""COCO RLE mask codec (pycocotools-compatible).

Counterpart of ``psalm_tpu/data/coco_rle.py``. pycocotools is not a
dependency; this module implements the COCO compressed-RLE wire format
(column-major run lengths, LEB128-style base-6-bit ASCII with delta coding)
used by the interactive / instance datasets (coco_instance_mapper.py RLE
visual prompts) and by the instance-AP evaluator. ``encode`` and ``decode``
run the native library (``psalm_tpu_torch/native``); the numpy codec beside
them (``encode_uncompressed``, ``decode_uncompressed``, ``_leb_encode``,
``_leb_decode``) is the reference the tests hold the library to.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from psalm_tpu_torch import native


def encode_uncompressed(mask: np.ndarray) -> Dict:
    """mask [H, W] {0,1} -> {'size': [H, W], 'counts': list} column-major."""
    H, W = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # runs of equal values, starting with 0s
    change = np.flatnonzero(np.diff(flat)) + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(boundaries)
    if flat.size and flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {"size": [H, W], "counts": runs.astype(np.int64).tolist()}


def decode_uncompressed(rle: Dict) -> np.ndarray:
    H, W = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < H * W:
        flat = np.concatenate([flat, np.zeros(H * W - flat.size, np.uint8)])
    return flat.reshape((H, W), order="F")


def _leb_encode(counts: List[int]) -> bytes:
    """pycocotools rleToString: delta-coded signed base-6-bit ASCII."""
    out = bytearray()
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            if c & 0x10:
                more = x != -1
            else:
                more = x != 0
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _leb_decode(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> Dict:
    """mask [H, W] {0,1} -> compressed RLE {'size', 'counts': bytes}."""
    return native.encode(mask)


def decode(rle: Dict) -> np.ndarray:
    """Compressed or uncompressed RLE -> mask [H, W] uint8."""
    return native.decode(rle)


def area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _leb_decode(counts)
    return int(np.sum(np.asarray(counts[1::2], np.int64)))


def iou(rle_a: Dict, rle_b: Dict) -> float:
    a = decode(rle_a).astype(bool)
    b = decode(rle_b).astype(bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


def merge_polygons_to_mask(polygons: List[List[float]], height: int,
                           width: int) -> np.ndarray:
    """COCO polygon segmentation -> binary mask (frPyObjects+merge analog).

    Uses the same fill convention as pycocotools (point-in-polygon on pixel
    centers, implemented via cv2.fillPoly on integer-rounded vertices)."""
    import cv2
    mask = np.zeros((height, width), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi rgb2id: R + 256*G + 256^2*B."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    out = np.zeros((*id_map.shape, 3), np.uint8)
    rem = id_map.astype(np.uint32)
    for i in range(3):
        out[..., i] = rem % 256
        rem //= 256
    return out
