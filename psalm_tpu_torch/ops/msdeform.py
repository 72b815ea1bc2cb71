"""Multi-scale deformable-attention sampling: kernel K1 and its plain twin.

Counterpart of ``psalm_tpu/ops/msdeform.py`` (the exact sampler) and of the
window-clamped samplers ``psalm_tpu/ops/msdeform_window.py``,
``msdeform_window_pallas2.py`` and ``msdeform_window_pallas3.py``: one
function with an optional clamp radius covers all of them.

Conventions (the JAX package's, which are the reference CUDA op's):
  value              [B, S, M, D]       S = sum_l H_l * W_l
  spatial_shapes     L pairs (H_l, W_l) of Python ints
  level_start        L ints, the offset of each level in S
  loc                [B, Q, M, L, P, 2] f32, (x, y) in [0, 1]
  attn               [B, Q, M, L, P]    softmaxed over L * P, value's dtype
  output             [B, Q, M * D]      value's dtype

Pixel coordinates are x = loc_x * W - 0.5 (``grid_sample`` with zeros
padding and ``align_corners=False``); off-image corners contribute zero.

With ``radius`` set, each sample's offset from its query's reference point is
clamped to +-radius target-level pixels first, with the semantics of
``psalm_tpu/ops/msdeform_window.py::_axis_taps``: c = ref + clip(coord - ref,
-r, r), floor, and corner validity from global coordinates. ``ref`` is
[Q, L, 2] f32 (x, y) target-level pixel coordinates; by default it is the
encoder's (Q == S, each query at its own pixel centre), built in float64 and
cast once, as ``_ref_grid`` builds it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from psalm_tpu_torch.ops import _build

#: Launches of the CUDA kernel since the last reset (the plain version and the
#: CPU path do not count).
LAUNCHES = 0

MAX_LEVELS = 8  # csrc/msdeform.cu::kMaxLevels

Shapes = Tuple[Tuple[int, int], ...]


def as_shapes(spatial_shapes) -> Shapes:
    """(H, W) pairs as a tuple of Python ints (a tensor is read once)."""
    if isinstance(spatial_shapes, torch.Tensor):
        spatial_shapes = spatial_shapes.tolist()
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def level_starts(spatial_shapes) -> Tuple[int, ...]:
    starts, s = [], 0
    for h, w in as_shapes(spatial_shapes):
        starts.append(s)
        s += h * w
    return tuple(starts)


def reference_grid(spatial_shapes) -> np.ndarray:
    """Encoder reference points as target-level pixel coordinates: [S, L, 2]
    f32 (x, y), where query s at (iy, ix) of level lq has, in level lv,
    ((i + 0.5) / n_q) * n_v - 0.5 per axis, computed in float64 and cast
    (``psalm_tpu/ops/msdeform_window.py::_ref_grid``)."""
    shapes = as_shapes(spatial_shapes)
    parts = []
    for hq, wq in shapes:
        per_level = []
        for hv, wv in shapes:
            ys = ((np.arange(hq, dtype=np.float64) + 0.5) / hq) * hv - 0.5
            xs = ((np.arange(wq, dtype=np.float64) + 0.5) / wq) * wv - 0.5
            gy = np.broadcast_to(ys[:, None], (hq, wq)).reshape(-1)
            gx = np.broadcast_to(xs[None, :], (hq, wq)).reshape(-1)
            per_level.append(np.stack([gx, gy], -1).astype(np.float32))
        parts.append(np.stack(per_level, 1))  # [Hq*Wq, L, 2]
    return np.ascontiguousarray(np.concatenate(parts, 0))


def _check_level_start(shapes: Shapes, level_start) -> None:
    if level_start is None:
        return
    if isinstance(level_start, torch.Tensor):
        level_start = level_start.tolist()
    if tuple(int(s) for s in level_start) != level_starts(shapes):
        raise ValueError(f"level_start {tuple(level_start)} does not match "
                         f"spatial_shapes {shapes}")


def _ref_tensor(ref, shapes: Shapes, Q: int, device) -> torch.Tensor:
    if ref is None:
        S = sum(h * w for h, w in shapes)
        if Q != S:
            raise ValueError(f"radius without ref needs the encoder case Q == S "
                             f"(Q={Q}, S={S})")
        ref = torch.from_numpy(reference_grid(shapes))
    return ref.to(device=device, dtype=torch.float32)


def ms_deform_attn_ref(value: torch.Tensor, spatial_shapes,
                       level_start, loc: torch.Tensor, attn: torch.Tensor,
                       radius: Optional[float] = None,
                       ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch sampler: four corner gathers per sample, weights and
    sums in f32 (``psalm_tpu/ops/msdeform.py:38-103``; with ``radius``, the
    clamp of ``psalm_tpu/ops/msdeform_window.py:111-138``)."""
    shapes = as_shapes(spatial_shapes)
    _check_level_start(shapes, level_start)
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    if L != len(shapes) or S != sum(h * w for h, w in shapes):
        raise ValueError(f"value/loc do not match spatial_shapes {shapes}")
    loc = loc.float()
    if radius is not None:
        ref = _ref_tensor(ref, shapes, Q, value.device)
    # [B, S, M, D] -> [B*M, S, D]; loc -> [B*M, Q, L, P, 2]; attn -> [B*M, Q, L, P]
    value_bm = value.permute(0, 2, 1, 3).reshape(B * M, S, D)
    loc_bm = loc.permute(0, 2, 1, 3, 4, 5).reshape(B * M, Q, L, P, 2)
    attn_bm = attn.permute(0, 2, 1, 3, 4).reshape(B * M, Q, L, P).float()

    out = torch.zeros(B * M, Q, D, dtype=torch.float32, device=value.device)
    for lid, (start, (H, W)) in enumerate(zip(level_starts(shapes), shapes)):
        value_l = value_bm[:, start:start + H * W]
        x = loc_bm[:, :, lid, :, 0] * W - 0.5  # [BM, Q, P]
        y = loc_bm[:, :, lid, :, 1] * H - 0.5
        if radius is not None:
            rx = ref[:, lid, 0][None, :, None]
            ry = ref[:, lid, 1][None, :, None]
            x = rx + torch.clamp(x - rx, -radius, radius)
            y = ry + torch.clamp(y - ry, -radius, radius)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.long()
        y0i = y0.long()
        sampled = torch.zeros(B * M, Q * P, D, dtype=torch.float32,
                              device=value.device)
        for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                            (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            yi = y0i + dy
            xi = x0i + dx
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B * M, Q * P)
            g = torch.gather(value_l, 1, idx[..., None].expand(-1, -1, D))
            w = (wgt * valid).reshape(B * M, Q * P, 1)
            sampled = sampled + g.float() * w
        sampled = sampled.reshape(B * M, Q, P, D)
        out = out + torch.einsum("bqpd,bqp->bqd", sampled, attn_bm[:, :, lid])
    out = out.reshape(B, M, Q, D).permute(0, 2, 1, 3).reshape(B, Q, M * D)
    return out.to(value.dtype)


def _check_inputs(value, loc, attn, ref, shapes: Shapes) -> None:
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn kernel: value is on {value.device}")
    if value.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ms_deform_attn kernel: value dtype {value.dtype} "
                        f"(takes {list(_build.DTYPE_CODES)})")
    if value.dim() != 4:
        raise ValueError(f"value must be [B, S, M, D], got {tuple(value.shape)}")
    B, S, M, D = value.shape
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels, got {len(shapes)}")
    if S != sum(h * w for h, w in shapes):
        raise ValueError(f"S={S} does not match spatial_shapes {shapes}")
    L = len(shapes)
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != M \
            or loc.shape[3] != L or loc.shape[5] != 2:
        raise ValueError(f"loc must be [B, Q, M, L, P, 2] = [{B}, Q, {M}, {L}, "
                         f"P, 2], got {tuple(loc.shape)}")
    if loc.dtype != torch.float32:
        raise TypeError(f"loc must be float32, got {loc.dtype}")
    Q, P = loc.shape[1], loc.shape[4]
    if tuple(attn.shape) != (B, Q, M, L, P):
        raise ValueError(f"attn must be {(B, Q, M, L, P)}, got "
                         f"{tuple(attn.shape)}")
    if attn.dtype != value.dtype:
        raise TypeError(f"attn dtype {attn.dtype} != value dtype {value.dtype}")
    tensors = [("value", value), ("loc", loc), ("attn", attn)]
    if ref is not None:
        if tuple(ref.shape) != (Q, L, 2) or ref.dtype != torch.float32:
            raise ValueError(f"ref must be float32 {(Q, L, 2)}, got "
                             f"{ref.dtype} {tuple(ref.shape)}")
        tensors.append(("ref", ref))
    for name, t in tensors:
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ms_deform_attn(value: torch.Tensor, spatial_shapes, level_start,
                   loc: torch.Tensor, attn: torch.Tensor,
                   radius: Optional[float] = None,
                   ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deformable sampler. A CPU tensor goes to the plain version; a CUDA
    tensor launches the CUDA kernel (csrc/msdeform.cu) or raises."""
    global LAUNCHES
    if value.device.type == "cpu":
        return ms_deform_attn_ref(value, spatial_shapes, level_start, loc,
                                  attn, radius=radius, ref=ref)
    lib = _build.library()
    shapes = as_shapes(spatial_shapes)
    _check_level_start(shapes, level_start)
    if radius is not None:
        ref = _ref_tensor(ref, shapes, loc.shape[1], value.device)
    _check_inputs(value, loc, attn, ref if radius is not None else None, shapes)
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty(B, Q, M * D, dtype=value.dtype, device=value.device)
    flat = [v for hw in shapes for v in hw]
    shapes_c = (ctypes.c_int * len(flat))(*flat)
    with torch.cuda.device(value.device):
        rc = lib.psalm_msdeform_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            ref.data_ptr() if radius is not None else None, out.data_ptr(),
            _build.DTYPE_CODES[value.dtype], B, S, Q, M, D, L, P,
            ctypes.cast(shapes_c, ctypes.c_void_p),
            float(radius) if radius is not None else 0.0,
            int(radius is not None), _build.stream_ptr(value.device))
    _build.check(lib, rc, "psalm_msdeform_fwd")
    LAUNCHES += 1
    return out
