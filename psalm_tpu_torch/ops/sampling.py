"""Bilinear resize on NHWC tensors, with the semantics of
``jax.image.resize(..., method="bilinear", antialias=False)`` that
``psalm_tpu/ops/sampling.py::resize_bilinear`` uses.

Each resized axis is one weight matrix: a triangle kernel of width 1 at the
half-pixel sample positions (i + 0.5) * in / out - 0.5, each output's weights
normalised to sum to 1, and zero for a sample outside [-0.5, in - 0.5]. For
upsampling and for downsampling without antialiasing that is
``F.interpolate(mode="bilinear", align_corners=False)``.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS_F32 = float(np.finfo(np.float32).eps)


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in_size, out_size] f32 weights, computed in f32 as JAX computes them
    (``jax._src.image.scale.compute_weight_mat``)."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :]
            - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS_F32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C]."""
    H, W = x.shape[-3], x.shape[-2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh != H:
        wh = resize_weights(H, oh, x.device).to(x.dtype)
        x = torch.einsum("...hwc,ho->...owc", x, wh)
    if ow != W:
        ww = resize_weights(W, ow, x.device).to(x.dtype)
        x = torch.einsum("...hwc,wo->...hoc", x, ww)
    return x
