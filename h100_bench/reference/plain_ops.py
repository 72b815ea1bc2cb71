"""The plain versions of the port's kernels that the reference runs: the
deformable sampler (K1, and by autograd K2), the Swin window-attention core
(K3) and softmax attention (K5). Frozen copies of the port's plain twins
(``ops/msdeform.py::ms_deform_attn_ref``, ``ops/swin_attention.py::
window_attention_ref``, ``ops/flash_attention.py::_ref_forward``), without
the window clamp and without the kernels. In f32 they round nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def ms_deform_attn(value: torch.Tensor, spatial_shapes, level_start,
                   loc: torch.Tensor, attn: torch.Tensor,
                   radius=None, ref=None) -> torch.Tensor:
    """value [B, S, M, D], loc [B, Q, M, L, P, 2] (x, y) in [0, 1], attn
    [B, Q, M, L, P] -> [B, Q, M * D]: four corner gathers per sample
    (``grid_sample`` with zeros padding, ``align_corners=False``), weights
    and sums in f32, the result in value's type."""
    if radius is not None:
        raise ValueError("the reference runs the exact sampler only")
    shapes = as_shapes(spatial_shapes)
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    if L != len(shapes) or S != sum(h * w for h, w in shapes):
        raise ValueError(f"value/loc do not match spatial_shapes {shapes}")
    value_bm = value.float().permute(0, 2, 1, 3).reshape(B * M, S, D)
    loc_bm = loc.float().permute(0, 2, 1, 3, 4, 5).reshape(B * M, Q, L, P, 2)
    attn_bm = attn.permute(0, 2, 1, 3, 4).reshape(B * M, Q, L, P).float()
    out = torch.zeros(B * M, Q, D, dtype=torch.float32, device=value.device)
    for lid, (start, (H, W)) in enumerate(zip(level_starts(shapes), shapes)):
        value_l = value_bm[:, start:start + H * W]
        x = loc_bm[:, :, lid, :, 0] * W - 0.5
        y = loc_bm[:, :, lid, :, 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        sampled = torch.zeros(B * M, Q * P, D, dtype=torch.float32,
                              device=value.device)
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yi, xi = y0i + dy, x0i + dx
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            rows = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(
                B * M, Q * P)
            g = torch.gather(value_l, 1, rows[..., None].expand(-1, -1, D))
            wy = fy if dy else 1 - fy
            wx = fx if dx else 1 - fx
            sampled = sampled + g * (wy * wx * valid).reshape(B * M, Q * P, 1)
        out = out + torch.einsum("bqpd,bqp->bqd",
                                 sampled.reshape(B * M, Q, P, D),
                                 attn_bm[:, :, lid])
    out = out.reshape(B, M, Q, D).permute(0, 2, 1, 3).reshape(B, Q, M * D)
    return out.to(value.dtype)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], nheads: int,
                     scale: float) -> torch.Tensor:
    """qkv [Bn, N, 3C], bias [h, N, N], mask [nW, N, N] or None ->
    [Bn, N, C]: softmax(q k^T * scale + bias (+ mask)) v, logits in f32, P
    in qkv's type before P v."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // nheads
    q = qkv[:, :, :C].reshape(Bn, N, nheads, hd)
    k = qkv[:, :, C:2 * C].reshape(Bn, N, nheads, hd)
    v = qkv[:, :, 2 * C:].reshape(Bn, N, nheads, hd)
    attn = torch.einsum("bnhd,bmhd->bhnm", (q * scale).float(), k.float())
    attn = attn + bias[None].float()
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.reshape(Bn // nW, nW, nheads, N, N)
                + mask.float()[None, :, None]).reshape(Bn, nheads, N, N)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.to(qkv.dtype), v)
    return out.reshape(Bn, N, C)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: float) -> torch.Tensor:
    """Softmax attention over [B, h, L, hd] in f32, in the inputs' type."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        L = q.shape[2]
        keys = torch.arange(k.shape[2], device=q.device)
        later = keys[None, :] > torch.arange(L, device=q.device)[:, None]
        logits = logits.masked_fill(later, float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v.float())
    return out.to(q.dtype)
