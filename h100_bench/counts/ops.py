"""Bytes and operations of one call of each of the port's op entries, from
its arguments' shapes, and the least time the card could take for it.

Counted as the function needs them, whatever implements it: each input
byte read once, each output byte written once, and the arithmetic of the
function (a multiply-add is two operations). The bound of a call is the
larger of bytes over the HBM rate and operations over the peak rate of the
compute type (``counts/peaks.json``); a roofline share is that bound over
the device time of the call.

* ``ms_deform_attn(value [B, S, M, D], shapes, starts, loc [B, Q, M, L, P,
  2] f32, attn [B, Q, M, L, P])``: reads value, loc and attn, writes out [B,
  Q, M D]. Operations: per sample (B Q M L P of them) four corner weights
  and four corner multiply-adds over D channels (8 D + 12), and the
  attention weight's multiply-add over D (2 D): (10 D + 12) a sample.
* its backward (kernel K2, ``_launch_bwd(lib, value, shapes, loc, attn,
  grad_out, radii, ref)``): reads value, loc, attn and grad_out, writes d
  value (value's size, f32 accumulated then rounded: counted once in
  value's type), d loc and d attn. Operations: the forward's per sample,
  twice (d value's four scatters and d attn's dot product, d loc's four
  corner dot products): (20 D + 24) a sample.
* ``window_attention(qkv [Bn, N, 3C], bias [h, N, N], mask [nW, N, N] or
  None, nheads, scale)``: reads qkv, bias and mask, writes out [Bn, N, C].
  Operations: q k^T and P v, 4 Bn N^2 C, and the softmax, 5 Bn h N^2.
* ``flash_attention(q, k, v [B, h, L, hd], causal, sm_scale)``: reads q,
  k, v, writes out. Operations: 4 B h hd L (L + 1) / 2 causal (4 B h hd
  L^2 without the mask), and the softmax, 5 B h L (L + 1) / 2.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

HERE = Path(__file__).resolve().parent


def peaks() -> Dict[str, float]:
    with open(HERE / "peaks.json") as f:
        return {k: float(v) for k, v in json.load(f).items()
                if k != "source"}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def bound_s(peak: Dict[str, float], flops: float, nbytes: float,
            low_precision: bool) -> float:
    rate = peak["bf16_flops_per_s" if low_precision else "f32_flops_per_s"]
    return max(nbytes / peak["hbm_bytes_per_s"], flops / rate)


def msdeform_fwd(value_shape, loc_shape, elt: int) -> Tuple[float, float]:
    """(operations, bytes) of one sampler call; ``elt`` value's bytes."""
    B, S, M, D = value_shape
    Q, L, P = loc_shape[1], loc_shape[3], loc_shape[4]
    samples = B * Q * M * L * P
    nbytes = (_numel(value_shape) * elt + samples * 2 * 4 + samples * elt
              + B * Q * M * D * elt)
    return samples * (10 * D + 12), nbytes


def msdeform_bwd(value_shape, loc_shape, elt: int) -> Tuple[float, float]:
    """(operations, bytes) of one sampler backward call."""
    B, S, M, D = value_shape
    Q, L, P = loc_shape[1], loc_shape[3], loc_shape[4]
    samples = B * Q * M * L * P
    value = _numel(value_shape) * elt
    loc = samples * 2 * 4
    attn = samples * elt
    grad_out = B * Q * M * D * elt
    nbytes = 2 * (value + loc + attn) + grad_out
    return samples * (20 * D + 24), nbytes


def window_attention(qkv_shape, elt: int, bias_bytes: int, mask_bytes: int,
                     nheads: int) -> Tuple[float, float]:
    """(operations, bytes) of one window-attention call; ``elt`` qkv's
    bytes, the bias and the mask (0 without one) in bytes whole."""
    Bn, N, C3 = qkv_shape
    C = C3 // 3
    nbytes = _numel(qkv_shape) * elt + bias_bytes + mask_bytes \
        + Bn * N * C * elt
    return 4 * Bn * N * N * C + 5 * Bn * nheads * N * N, nbytes


def flash_attention(q_shape, causal: bool, elt: int) -> Tuple[float, float]:
    """(operations, bytes) of one attention call over [B, h, L, hd]."""
    B, h, L, hd = q_shape
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4 * B * h * hd * pairs + 5 * B * h * pairs
    return flops, 4 * _numel(q_shape) * elt


# the harness's span wrappers: bound seconds of a call from its arguments


def msdeform_fwd_bound(peak, value, spatial_shapes, level_start, loc, attn,
                       radius=None, ref=None) -> float:
    flops, nbytes = msdeform_fwd(value.shape, loc.shape, value.element_size())
    return bound_s(peak, flops, nbytes, value.element_size() < 4)


def msdeform_bwd_bound(peak, lib, value, shapes, loc, attn, grad_out, radii,
                       ref) -> float:
    flops, nbytes = msdeform_bwd(value.shape, loc.shape, value.element_size())
    return bound_s(peak, flops, nbytes, value.element_size() < 4)


def window_attention_bound(peak, qkv, bias, mask, nheads, scale) -> float:
    mask_bytes = 0 if mask is None else mask.numel() * mask.element_size()
    flops, nbytes = window_attention(qkv.shape, qkv.element_size(),
                                     bias.numel() * bias.element_size(),
                                     mask_bytes, nheads)
    return bound_s(peak, flops, nbytes, qkv.element_size() < 4)


def flash_attention_bound(peak, q, k, v, *, causal, sm_scale) -> float:
    flops, nbytes = flash_attention(q.shape, causal, q.element_size())
    return bound_s(peak, flops, nbytes, q.element_size() < 4)
