"""Crop-then-resize eval geometry as interpolation matrices.

Counterpart of ``psalm_tpu/eval/geometry.py``. The reference's order for
every head but the semantic task's: upsample mask logits x4 to the padded
frame, crop the un-padded content [0:nh, 0:nw], resize bilinearly to the
original (H, W), then run the heads at (H, W) (``crop_resize_to_original``).
The semantic task runs its head at the padded frame and then crops and
resizes (``resize_to_original``). Each step is linear and separable per axis, so
each axis is one matrix: crop-and-resize ``M`` [bucket, S] composed with the
static x4 upsample ``U`` [S, S/4]. Rows past the image's true size are zero
("bucket" is a fixed upper bound on original sizes).

Weights follow torch ``F.interpolate(mode="bilinear", align_corners=False)``:
src = (dst + 0.5) * in / out - 0.5, clamped at 0, second tap clamped to
in - 1. Everything is f32 ``torch.matmul``; on a GPU the caller keeps
``torch.backends.cuda.matmul.allow_tf32`` False (its default), since TF32
would move the logits that the heads threshold.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def interp_matrix(in_valid: int, out_valid: int, in_size: int, out_size: int,
                  device=None) -> torch.Tensor:
    """[out_size, in_size] f32: the first ``in_valid`` inputs resized onto the
    first ``out_valid`` outputs; rows >= out_valid are zero. Computed in f32
    in the JAX package's order of operations."""
    in_v = torch.tensor(float(in_valid), dtype=torch.float32, device=device)
    out_v = torch.tensor(float(out_valid), dtype=torch.float32, device=device)
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    src = torch.clamp((i + 0.5) * (in_v / out_v) - 0.5, min=0.0)
    hi = int(in_valid) - 1
    i0 = torch.clamp(torch.floor(src).int(), max=hi)
    i1 = torch.clamp(i0 + 1, max=hi)
    w1 = src - i0.float()
    w0 = 1.0 - w1
    k = torch.arange(in_size, dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    m = (torch.where(k[None, :] == i0[:, None], w0[:, None], zero)
         + torch.where(k[None, :] == i1[:, None], w1[:, None], zero))
    return m * (i[:, None] < out_v)


@functools.lru_cache(maxsize=8)
def _upsample_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    i = np.arange(out_size, dtype=np.float64)
    src = np.maximum((i + 0.5) * (in_size / out_size) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0
    m = np.zeros((out_size, in_size), np.float64)
    m[np.arange(out_size), i0] += 1.0 - w1
    m[np.arange(out_size), i1] += w1
    m = m.astype(np.float32)
    m.setflags(write=False)
    return m


def crop_resize_matrix(content: int, original: int, lowres_size: int,
                       padded_size: int, bucket: int, device=None) -> torch.Tensor:
    """[bucket, lowres_size]: crop-and-resize (content -> original) after
    the static x4 upsample (lowres -> padded frame)."""
    up = torch.tensor(_upsample_matrix_np(lowres_size, padded_size), device=device)
    return interp_matrix(content, original, padded_size, bucket, device) @ up


def crop_resize_to_original(x: torch.Tensor, content_hw, original_hw,
                            padded_size: int, bucket_hw) -> torch.Tensor:
    """[..., h, w] mask-resolution logits -> [..., Hb, Wb] f32, zero past
    the original (H, W)."""
    x = x.float()
    h, w = x.shape[-2], x.shape[-1]
    ch = crop_resize_matrix(content_hw[0], original_hw[0], h, padded_size,
                            bucket_hw[0], x.device)
    cw = crop_resize_matrix(content_hw[1], original_hw[1], w, padded_size,
                            bucket_hw[1], x.device)
    return torch.matmul(torch.matmul(ch, x), cw.T)


def resize_to_original(x: torch.Tensor, content_hw, original_hw,
                       bucket_hw) -> torch.Tensor:
    """The crop [0:nh, 0:nw] and bilinear resize to (H, W) alone, for maps
    already at the padded frame (the semantic task's head output):
    [..., S, S] -> [..., Hb, Wb] f32, zero past the original (H, W)."""
    x = x.float()
    mh = interp_matrix(content_hw[0], original_hw[0], x.shape[-2],
                       bucket_hw[0], x.device)
    mw = interp_matrix(content_hw[1], original_hw[1], x.shape[-1],
                       bucket_hw[1], x.device)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def valid_mask(original_hw, bucket_hw, device=None) -> torch.Tensor:
    """[Hb, Wb] bool, True on the image's (H, W) pixels."""
    rows = torch.arange(bucket_hw[0], device=device) < int(original_hw[0])
    cols = torch.arange(bucket_hw[1], device=device) < int(original_hw[1])
    return rows[:, None] & cols[None, :]
