"""The per-element limits that K1 and K3 are held to on the card
(``ms_deform_attn_limit``, ``window_attention_limit``), held against
plain-torch emulations of the kernels' arithmetic on the CPU.

The bf16 tensor-core K3 (``csrc/swin_attention.cu``) rounds q * scale and
P to bf16 where the twin does, sums S and P v in f32 in another order, and
rounds the output once; its limit allows one bf16 step of the output plus
2^-8 of P |v| (``window_attention_magnitude``). K1 (``csrc/msdeform.cu``)
sums the same f32 terms in another order and rounds once; its limit allows
one bf16 step (bf16) or 1e-5 of the output, plus 1e-5 of the sum of the
absolute terms (``ms_deform_attn_magnitude``). Here: the emulations lie
within the limits, and emulations of broken kernels (K3 without the scale
or without the bias, K1 with its bilinear fractions swapped) fail them by
more than 10x, as the mutants of ``tools/kernel_mutants.py`` must on the
card.
"""

import math

import numpy as np
import pytest
import torch

from psalm_tpu_torch.models.swin import shift_attn_mask
from psalm_tpu_torch.ops import msdeform
from psalm_tpu_torch.ops import swin_attention as sa

# (N, C, heads, window layout): Swin-B's 12x12 window at stage 0 with the
# shift mask of a 24x24 map (4 windows), a ragged 7x7 window, the tiny 4x4
WINDOWS = [(144, 128, 4, 12), (49, 128, 4, 7), (16, 32, 2, 4)]


def _swin_inputs(N, C, h, ws, seed=0):
    rng = np.random.default_rng(seed + N)
    Hp = 2 * ws
    mask = torch.from_numpy(shift_attn_mask(Hp, Hp, ws, ws // 2))
    nW = mask.shape[0]
    qkv = torch.from_numpy(rng.standard_normal((2 * nW, N, 3 * C)).astype(
        np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal((h, N, N)).astype(np.float32))
    return qkv, bias, mask


def emulate_k3(qkv, bias, mask, h, scale, with_bias=True):
    """The bf16 tensor-core K3's arithmetic: q * scale rounded to bf16, S in
    f32, + bias and mask in f32, softmax in f32 normalised before P is
    rounded to bf16, P v summed in f32 over 16-key chunks, the output
    rounded once."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // h
    q, k, v = (qkv[:, :, i * C:(i + 1) * C].reshape(Bn, N, h, hd)
               for i in range(3))
    s = torch.einsum("bnhd,bmhd->bhnm", (q * scale).float(), k.float())
    if with_bias:
        s = s + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, h, N, N)
             + mask[None, :, None]).reshape(Bn, h, N, N)
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    o = torch.zeros(Bn, N, h, hd)
    for j0 in range(0, N, 16):
        o += torch.einsum("bhnm,bmhd->bnhd", p[..., j0:j0 + 16],
                          v[:, j0:j0 + 16].float())
    return o.reshape(Bn, N, C).to(torch.bfloat16)


def _k3_worst(qkv, bias, mask, h, got):
    scale = (qkv.shape[2] // 3 // h) ** -0.5
    want = sa.window_attention_ref(qkv, bias, mask, h, scale)
    mag = sa.window_attention_magnitude(qkv, bias, mask, h, scale)
    limit = sa.window_attention_limit(want, mag, torch.bfloat16)
    return ((got.float() - want.float()).abs() / limit).max().item()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,C,h,ws", WINDOWS)
def test_emulated_bf16_k3_lies_within_the_limit(N, C, h, ws, masked):
    qkv, bias, mask = _swin_inputs(N, C, h, ws)
    m = mask if masked else None
    got = emulate_k3(qkv, bias, m, h, (C // h) ** -0.5)
    assert _k3_worst(qkv, bias, m, h, got) <= 1.0


@pytest.mark.parametrize("N,C,h,ws", WINDOWS)
def test_k3_without_the_scale_fails_the_limit(N, C, h, ws):
    qkv, bias, mask = _swin_inputs(N, C, h, ws)
    got = emulate_k3(qkv, bias, mask, h, 1.0)
    assert _k3_worst(qkv, bias, mask, h, got) > 10.0


@pytest.mark.parametrize("N,C,h,ws", WINDOWS)
def test_k3_without_the_bias_fails_the_limit(N, C, h, ws):
    qkv, bias, mask = _swin_inputs(N, C, h, ws)
    got = emulate_k3(qkv, bias, mask, h, (C // h) ** -0.5, with_bias=False)
    assert _k3_worst(qkv, bias, mask, h, got) > 10.0


def test_k3_f32_limit_and_magnitude_definitions():
    """f32: the limit is 1e-5 of the output and of the magnitude; the
    magnitude is P |v| on whole matrices, from the twin's probabilities."""
    N, C, h, ws = WINDOWS[1]
    qkv, bias, mask = _swin_inputs(N, C, h, ws)
    qkv = qkv.float()
    scale = (C // h) ** -0.5
    want = sa.window_attention_ref(qkv, bias, mask, h, scale)
    mag = sa.window_attention_magnitude(qkv, bias, mask, h, scale)
    torch.testing.assert_close(sa.window_attention_limit(want, mag,
                                                         torch.float32),
                               1e-5 * want.abs() + 1e-5 * mag)
    Bn, hd = qkv.shape[0], C // h
    q, k, v = (qkv[:, :, i * C:(i + 1) * C].reshape(Bn, N, h, hd)
               .transpose(1, 2) for i in range(3))
    s = q @ k.transpose(-1, -2) * scale + bias[None]
    s = (s.reshape(Bn // mask.shape[0], mask.shape[0], h, N, N)
         + mask[None, :, None]).reshape(Bn, h, N, N)
    p = torch.softmax(s, -1)
    torch.testing.assert_close(
        mag, (p @ v.abs()).transpose(1, 2).reshape(Bn, N, C), rtol=1e-5,
        atol=1e-6)


def _deform_inputs(seed=0):
    """Pallas3's level shapes with offsets to 12 px, beyond radius 8 and
    off the border."""
    shapes = ((16, 16), (8, 8), (4, 4))
    B, M, D, P, L = 2, 2, 8, 2, 3
    S = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(seed)
    ref = msdeform.reference_grid(shapes)  # [S, L, 2] target-level pixels
    norm = np.array([[w, h] for h, w in shapes], np.float32)
    off = rng.uniform(-12, 12, size=(B, S, M, L, P, 2)).astype(np.float32)
    loc = ((ref[None, :, None, :, None, :] + 0.5 + off)
           / norm[None, None, None, :, None, :]).astype(np.float32)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    attn = rng.random((B, S, M, L, P)).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    return (torch.from_numpy(value).to(torch.bfloat16), shapes,
            torch.from_numpy(loc), torch.from_numpy(attn).to(torch.bfloat16))


def emulate_k1(value, shapes, loc, attn, swap=False):
    """K1's arithmetic: per sample the four corner taps in f32 (weights
    from the fractions past the top-left corner, off-image corners zero),
    times the attention weight, summed over levels and points in f32 in
    the kernel's order, rounded once. ``swap`` exchanges the fractions."""
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    vf, af = value.float(), attn.float()
    out = torch.zeros(B, Q, M, D)
    start = 0
    for lv, (H, W) in enumerate(shapes):
        vl = vf[:, start:start + H * W]  # [B, H W, M, D]
        start += H * W
        for p in range(P):
            x = loc[:, :, :, lv, p, 0] * W - 0.5  # [B, Q, M]
            y = loc[:, :, :, lv, p, 1] * H - 0.5
            x0, y0 = torch.floor(x), torch.floor(y)
            fx, fy = x - x0, y - y0
            if swap:
                fx, fy = fy, fx
            s = torch.zeros(B, Q, M, D)
            for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)),
                               (0, 1, (1 - fy) * fx), (1, 0, fy * (1 - fx)),
                               (1, 1, fy * fx)):
                xi, yi = (x0 + dx).long(), (y0 + dy).long()
                ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
                g = torch.gather(vl, 1, idx[..., None].expand(-1, -1, -1, D))
                s += (wt * ok)[..., None] * g
            out += af[:, :, :, lv, p, None] * s
    return out.reshape(B, Q, M * D).to(value.dtype)


def _k1_worst(value, shapes, loc, attn, got):
    starts = msdeform.level_starts(shapes)
    want = msdeform.ms_deform_attn_ref(value, shapes, starts, loc, attn)
    mag = msdeform.ms_deform_attn_magnitude(value, shapes, starts, loc, attn)
    limit = msdeform.ms_deform_attn_limit(want, mag, value.dtype)
    diff = (got.float() - want.float()).abs()
    return (diff / limit).masked_fill(diff == 0, 0.0).max().item()


def test_emulated_bf16_k1_lies_within_the_limit():
    value, shapes, loc, attn = _deform_inputs()
    assert _k1_worst(value, shapes, loc, attn,
                     emulate_k1(value, shapes, loc, attn)) <= 1.0


def test_k1_with_swapped_fractions_fails_the_limit():
    value, shapes, loc, attn = _deform_inputs()
    got = emulate_k1(value, shapes, loc, attn, swap=True)
    assert _k1_worst(value, shapes, loc, attn, got) > 10.0


def test_k1_magnitude_sums_absolute_terms():
    """The magnitude is the twin on |value| and |attn|: no smaller than the
    output's size, and equal to it where every term is positive."""
    value, shapes, loc, attn = _deform_inputs(1)
    starts = msdeform.level_starts(shapes)
    value = value.float()
    want = msdeform.ms_deform_attn_ref(value, shapes, starts, loc, attn)
    mag = msdeform.ms_deform_attn_magnitude(value, shapes, starts, loc, attn)
    assert mag.dtype == torch.float32
    assert (mag >= want.abs() - 1e-6).all()
    pos = msdeform.ms_deform_attn_ref(value.abs(), shapes, starts, loc, attn)
    torch.testing.assert_close(mag, pos.float())
    limit = msdeform.ms_deform_attn_limit(want, mag, torch.float32)
    torch.testing.assert_close(limit, 1e-5 * want.abs() + 1e-5 * mag)
    assert not math.isnan(limit.sum().item())
