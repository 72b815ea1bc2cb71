"""Multi-scale deformable-attention sampling: kernel K1, its backward K2,
and their plain twins.

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

``ms_deform_attn`` is differentiable in value, loc and attn. On the card the
backward is kernel K2 (``csrc/msdeform_bwd.cu``, ``ms_deform_attn_bwd``): the
gradient AD of ``psalm_tpu/ops/msdeform.py::ms_deform_attn_xla`` gives, and
with ``radius`` the VJP of ``psalm_tpu/ops/msdeform_window.py::
ms_deform_attn_window`` (zero d loc on an axis whose offset was clipped).
On the CPU it is autograd through ``ms_deform_attn_ref``, the plain twin,
whose value gradient is likewise summed in f32 and rounded once.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from psalm_tpu_torch.ops import _build

#: Launches of the CUDA kernels K1 and K2 since the last reset (the plain
#: versions and the CPU path do not count).
LAUNCHES = 0
BWD_LAUNCHES = 0

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


def _level_coords(loc_bm, lid: int, H: int, W: int, radius, ref):
    """Level ``lid``'s sample coordinates in level pixels, x = loc_x W - 0.5
    (and y), clamped to +-radius of ``ref`` when a radius is given, and
    whether the clamp passed each axis (its gradient gate): (x, y, pass_x,
    pass_y), [BM, Q, P] each."""
    x = loc_bm[:, :, lid, :, 0] * W - 0.5
    y = loc_bm[:, :, lid, :, 1] * H - 0.5
    if radius is None:
        return x, y, None, None
    rx = ref[:, lid, 0][None, :, None]
    ry = ref[:, lid, 1][None, :, None]
    dx, dy = x - rx, y - ry
    return (rx + torch.clamp(dx, -radius, radius),
            ry + torch.clamp(dy, -radius, radius),
            dx.abs() <= radius, dy.abs() <= radius)


def _corners(value_l, x, y, H: int, W: int):
    """The bilinear tap of every sample: (fx, fy, (valid, rows, gathered)),
    the fractions past the top-left corner [BM, Q, P], and for the corners
    (0, 0), (0, 1), (1, 0), (1, 1) as (dy, dx) whether each lies on the
    image [BM, Q, P], its row in ``value_l`` [BM, Q * P] (clamped where it
    does not) and that row [BM, Q * P, D]."""
    BM, Q, P = x.shape
    D = value_l.shape[-1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x0i, y0i = x0.long(), y0.long()
    valid, rows, gathered = [], [], []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0i + dy, x0i + dx
        valid.append((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))
        rows.append((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
                    .reshape(BM, Q * P))
        gathered.append(torch.gather(value_l, 1,
                                     rows[-1][..., None].expand(-1, -1, D)))
    return x - x0, y - y0, (valid, rows, gathered)


def _corner_weights(fx, fy):
    """The (y, x) factors of the four corners' bilinear weights, in
    ``_corners``' order."""
    gx, gy = 1 - fx, 1 - fy
    return (gy, gx), (gy, fx), (fy, gx), (fy, fx)


def ms_deform_attn_ref(value: torch.Tensor, spatial_shapes,
                       level_start, loc: torch.Tensor, attn: torch.Tensor,
                       radius: Optional[float] = None,
                       ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch sampler: four corner gathers per sample, weights and
    sums in f32 (``psalm_tpu/ops/msdeform.py:38-103``; with ``radius``, the
    clamp of ``psalm_tpu/ops/msdeform_window.py:111-138``). The gathers read
    value upcast to f32, so under autograd its gradient is summed in f32 and
    rounded to value's type once, as K2 does."""
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
    value_bm = value.float().permute(0, 2, 1, 3).reshape(B * M, S, D)
    loc_bm = loc.permute(0, 2, 1, 3, 4, 5).reshape(B * M, Q, L, P, 2)
    attn_bm = attn.permute(0, 2, 1, 3, 4).reshape(B * M, Q, L, P).float()

    out = torch.zeros(B * M, Q, D, dtype=torch.float32, device=value.device)
    for lid, (start, (H, W)) in enumerate(zip(level_starts(shapes), shapes)):
        value_l = value_bm[:, start:start + H * W]
        x, y = _level_coords(loc_bm, lid, H, W, radius, ref)[:2]
        fx, fy, corners = _corners(value_l, x, y, H, W)
        sampled = torch.zeros(B * M, Q * P, D, dtype=torch.float32,
                              device=value.device)
        for (wy, wx), valid, _, g in zip(_corner_weights(fx, fy), *corners):
            w = (wy * wx * valid).reshape(B * M, Q * P, 1)
            sampled = sampled + g * w
        sampled = sampled.reshape(B * M, Q, P, D)
        out = out + torch.einsum("bqpd,bqp->bqd", sampled, attn_bm[:, :, lid])
    out = out.reshape(B, M, Q, D).permute(0, 2, 1, 3).reshape(B, Q, M * D)
    return out.to(value.dtype)


def ms_deform_attn_magnitude(value: torch.Tensor, spatial_shapes,
                             level_start, loc: torch.Tensor,
                             attn: torch.Tensor,
                             radius: Optional[float] = None,
                             ref: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The twin on |value| and |attn| in f32 [B, Q, M * D]: the bilinear
    weights are >= 0, so per output element the sum of the absolute values
    of its terms, the size that the order of f32 sums acts on."""
    return ms_deform_attn_ref(value.float().abs(), spatial_shapes,
                              level_start, loc, attn.float().abs(),
                              radius=radius, ref=ref)


def ms_deform_attn_limit(want: torch.Tensor, magnitude: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """Per element, the most K1's output may differ from the twin's
    ``want``: 1e-5 of the ``magnitude`` (f32 sums in another order), plus
    one bf16 step of the output in bf16 (2^-7 |want|: both sides sum in f32
    and round once) or 1e-5 |want| in f32."""
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    return rtol * want.float().abs() + 1e-5 * magnitude.float()


def ms_deform_attn_bwd_magnitude(value, spatial_shapes, level_start, loc,
                                 attn, grad_out,
                                 radius: Optional[float] = None,
                                 ref: Optional[torch.Tensor] = None):
    """Per element of (d value, d loc, d attn), the sum of the absolute
    values of its terms in f32, and each gradient's most terms an element
    sums: ((m_value, m_loc, m_attn), (n_value, n_loc, n_attn)).
      d value: the twin's d value with |g| and |attn| (its terms g a w have
        w >= 0); n_value the most samples' corners that reach one element.
      d attn: sum_d |g_d| sample_d(|value|).
      d loc_x: W |a| sum_d |g_d| (gy (|v00| + |v01|) + fy (|v10| + |v11|)),
        d loc_y likewise with H, gx, fx and the corners' other pairs; zero on
        an axis whose offset the clamp clipped, where both sides are 0.
    d loc and d attn sum 4 D channel terms."""
    shapes = as_shapes(spatial_shapes)
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    g_abs = grad_out.float().abs()
    m_value = ms_deform_attn_bwd_ref(value.float(), shapes, level_start, loc,
                                     attn.float().abs(), g_abs, radius=radius,
                                     ref=ref)[0]
    if radius is not None:
        ref = _ref_tensor(ref, shapes, Q, value.device)
    value_bm = value.float().abs().permute(0, 2, 1, 3).reshape(B * M, S, D)
    loc_bm = loc.float().permute(0, 2, 1, 3, 4, 5).reshape(B * M, Q, L, P, 2)
    attn_bm = attn.float().abs().permute(0, 2, 1, 3, 4).reshape(B * M, Q, L, P)
    g_bm = g_abs.reshape(B, Q, M, D).permute(0, 2, 1, 3).reshape(B * M, Q, 1, D)
    m_loc = torch.zeros(B * M, Q, L, P, 2, device=value.device)
    m_attn = torch.zeros(B * M, Q, L, P, device=value.device)
    hits = torch.zeros(B * M, S, dtype=torch.long, device=value.device)
    for lid, (start, (H, W)) in enumerate(zip(level_starts(shapes), shapes)):
        x, y, pass_x, pass_y = _level_coords(loc_bm, lid, H, W, radius, ref)
        fx, fy, (valid, rows, gathered) = _corners(
            value_bm[:, start:start + H * W], x, y, H, W)
        # sum_d |g_d| |v_corner, d| per sample and corner, [BM, Q, P]
        gv = [(g.reshape(B * M, Q, P, D) * g_bm).sum(-1) * ok
              for ok, g in zip(valid, gathered)]
        m_attn[:, :, lid] = sum(wy * wx * t for (wy, wx), t
                                in zip(_corner_weights(fx, fy), gv))
        a = attn_bm[:, :, lid]
        mx = W * a * ((1 - fy) * (gv[0] + gv[1]) + fy * (gv[2] + gv[3]))
        my = H * a * ((1 - fx) * (gv[0] + gv[2]) + fx * (gv[1] + gv[3]))
        if radius is not None:
            mx, my = mx * pass_x, my * pass_y
        m_loc[:, :, lid, :, 0], m_loc[:, :, lid, :, 1] = mx, my
        for ok, row in zip(valid, rows):
            hits.scatter_add_(1, start + row, ok.reshape(B * M, Q * P).long())
    m_loc = m_loc.reshape(B, M, Q, L, P, 2).permute(0, 2, 1, 3, 4, 5)
    m_attn = m_attn.reshape(B, M, Q, L, P).permute(0, 2, 1, 3, 4)
    return ((m_value.float(), m_loc.contiguous(), m_attn.contiguous()),
            (int(hits.max().item()) if hits.numel() else 0, 4 * D, 4 * D))


def ms_deform_attn_bwd_limit(want, magnitude, dtype: torch.dtype):
    """Per element of K2's (d value, d loc, d attn), the most it may differ
    from the twin's ``want``: rtol |want| + c M, with M and the term counts
    n from ``ms_deform_attn_bwd_magnitude``.
      rtol: 2^-7, one bf16 step, for d value and d attn in bf16 (both sides
        sum in f32 and round to bf16 once); 1e-5 for d loc (f32) and in f32.
      c = max(1e-5, 2 (n + 2) 2^-24): each side's f32 sum of n terms in its
        own order is off by at most (n - 1) u M, u = 2^-24, and each term's
        two or three products by 3 u of it; the two sides' errors add. d
        value sums through atomics in an order that changes from run to
        run; its n is the most samples' corners reaching one element
        (hundreds at the 1024^2 encoder shapes), d loc's and d attn's 4 D.
    """
    (m_value, m_loc, m_attn), terms = magnitude
    limits = []
    for w, m, n, rounded in zip(want, (m_value, m_loc, m_attn), terms,
                                (True, False, True)):
        rtol = 2.0 ** -7 if rounded and dtype == torch.bfloat16 else 1e-5
        c = max(1e-5, 2 * (n + 2) * 2.0 ** -24)
        limits.append(rtol * w.float().abs() + c * m.float())
    return tuple(limits)


def _check_inputs(value, loc, attn, ref, shapes: Shapes) -> None:
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn kernel: value is on {value.device}")
    if value.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ms_deform_attn kernel: value dtype {value.dtype} "
                        f"(takes {list(_build.DTYPE_CODES)})")
    if value.dim() != 4:
        raise ValueError(f"value must be [B, S, M, D], got {tuple(value.shape)}")
    B, S, M, D = value.shape
    vec = 16 // value.element_size()  # channels in a 16-byte vector
    if D > 32 and (D % vec or D > 32 * vec):
        raise ValueError(f"D={D}: the kernels take a head of at most 32 "
                         f"threads ({32 * vec} channels in 16-byte vectors, "
                         f"32 single)")
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


def _launch_fwd(lib, value, shapes: Shapes, loc, attn, radius, ref):
    global LAUNCHES
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty(B, Q, M * D, dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        rc = lib.psalm_msdeform_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            ref.data_ptr() if radius is not None else None, out.data_ptr(),
            _build.DTYPE_CODES[value.dtype], B, S, Q, M, D, L, P,
            _shapes_c(shapes), float(radius) if radius is not None else 0.0,
            int(radius is not None), _build.stream_ptr(value.device))
    _build.check(lib, rc, "psalm_msdeform_fwd")
    LAUNCHES += 1
    return out


def _shapes_c(shapes: Shapes) -> ctypes.c_void_p:
    flat = [v for hw in shapes for v in hw]
    return ctypes.cast((ctypes.c_int * len(flat))(*flat), ctypes.c_void_p)


def _launch_bwd(lib, value, shapes: Shapes, loc, attn, grad_out, radius, ref):
    """K2: (d value, d loc, d attn). The kernel sums d value in an f32
    accumulator, which it zeroes, and rounds it to value's type once (for
    f32 the accumulator is d value)."""
    global BWD_LAUNCHES
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(grad_out.shape) != (B, Q, M * D) or grad_out.dtype != value.dtype \
            or grad_out.device != value.device or not grad_out.is_contiguous():
        raise ValueError(f"grad_out must be contiguous {value.dtype} "
                         f"{(B, Q, M * D)} on {value.device}, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)}")
    grad_value = torch.empty_like(value)
    acc = grad_value if value.dtype == torch.float32 else torch.empty(
        B, S, M, D, dtype=torch.float32, device=value.device)
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    with torch.cuda.device(value.device):
        rc = lib.psalm_msdeform_bwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            ref.data_ptr() if radius is not None else None,
            grad_out.data_ptr(), grad_value.data_ptr(), acc.data_ptr(),
            grad_loc.data_ptr(), grad_attn.data_ptr(),
            _build.DTYPE_CODES[value.dtype], B, S, Q, M, D, L, P,
            _shapes_c(shapes), float(radius) if radius is not None else 0.0,
            int(radius is not None), _build.stream_ptr(value.device))
    _build.check(lib, rc, "psalm_msdeform_bwd")
    BWD_LAUNCHES += 1
    return grad_value, grad_loc, grad_attn


def _prepare(value, spatial_shapes, level_start, loc, attn, radius, ref):
    """The loaded library, the shapes and the clamp's reference grid, after
    the inputs are checked."""
    lib = _build.library()
    shapes = as_shapes(spatial_shapes)
    _check_level_start(shapes, level_start)
    if radius is not None:
        ref = _ref_tensor(ref, shapes, loc.shape[1], value.device)
    _check_inputs(value, loc, attn, ref if radius is not None else None, shapes)
    return lib, shapes, ref


class _MSDeformAttn(torch.autograd.Function):
    """K1 forward, K2 backward; no gradient for the shapes, radius or ref."""

    @staticmethod
    def forward(ctx, value, loc, attn, lib, shapes, radius, ref):
        ctx.save_for_backward(value, loc, attn, ref)
        ctx.lib, ctx.shapes, ctx.radius = lib, shapes, radius
        return _launch_fwd(lib, value, shapes, loc, attn, radius, ref)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn, ref = ctx.saved_tensors
        grads = _launch_bwd(ctx.lib, value, ctx.shapes, loc, attn,
                            grad_out.contiguous(), ctx.radius, ref)
        return (*grads, None, None, None, None)


def ms_deform_attn(value: torch.Tensor, spatial_shapes, level_start,
                   loc: torch.Tensor, attn: torch.Tensor,
                   radius: Optional[float] = None,
                   ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deformable sampler. A CPU tensor goes to the plain version; a CUDA
    tensor launches the CUDA kernel (csrc/msdeform.cu) or raises. Its
    gradient is kernel K2 on the card (csrc/msdeform_bwd.cu)."""
    if value.device.type == "cpu":
        return ms_deform_attn_ref(value, spatial_shapes, level_start, loc,
                                  attn, radius=radius, ref=ref)
    lib, shapes, ref = _prepare(value, spatial_shapes, level_start, loc, attn,
                                radius, ref)
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or attn.requires_grad):
        return _MSDeformAttn.apply(value, loc, attn, lib, shapes, radius, ref)
    return _launch_fwd(lib, value, shapes, loc, attn, radius, ref)


def ms_deform_attn_bwd_ref(value, spatial_shapes, level_start, loc, attn,
                           grad_out, radius: Optional[float] = None,
                           ref: Optional[torch.Tensor] = None):
    """The plain twin of K2: (d value, d loc, d attn) by autograd through
    ``ms_deform_attn_ref``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (value, loc, attn)]
        out = ms_deform_attn_ref(leaves[0], spatial_shapes, level_start,
                                 leaves[1], leaves[2], radius=radius, ref=ref)
        return torch.autograd.grad(out, leaves, grad_out)


def ms_deform_attn_bwd(value, spatial_shapes, level_start, loc, attn,
                       grad_out, radius: Optional[float] = None,
                       ref: Optional[torch.Tensor] = None):
    """(d value, d loc, d attn) of ``ms_deform_attn`` for the output gradient
    ``grad_out`` [B, Q, M * D]: ``ms_deform_attn_bwd_ref`` for a CPU tensor,
    else kernel K2 or an error."""
    if value.device.type == "cpu":
        return ms_deform_attn_bwd_ref(value, spatial_shapes, level_start, loc,
                                      attn, grad_out, radius=radius, ref=ref)
    lib, shapes, ref = _prepare(value, spatial_shapes, level_start, loc, attn,
                                radius, ref)
    return _launch_bwd(lib, value, shapes, loc, attn, grad_out, radius, ref)
