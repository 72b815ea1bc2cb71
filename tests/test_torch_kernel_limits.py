"""The per-element limits that K1, K2, K3 and K3's backward are held to on
the card (``ms_deform_attn_limit``, ``ms_deform_attn_bwd_limit``,
``window_attention_limit``, ``window_attention_bwd_limit``), held against
plain-torch emulations of the kernels' arithmetic on the CPU.

The bf16 tensor-core K3 (``csrc/swin_attention.cu``) rounds q * scale and
P to bf16 where the twin does, sums S and P v in f32 in another order, and
rounds the output once; its limit allows one bf16 step of the output plus
2^-8 of P |v| (``window_attention_magnitude``). K1 (``csrc/msdeform.cu``)
sums the same f32 terms in another order and rounds once; its limit allows
one bf16 step (bf16) or 1e-5 of the output, plus 1e-5 of the sum of the
absolute terms (``ms_deform_attn_magnitude``). K2 (``csrc/msdeform_bwd.cu``)
sums each sample's d attn and d loc over a thread's channels, then over
the head's threads by a shuffle tree, and d value through atomics in an
order that changes from run to run; its limit allows one bf16 step of d
value and d attn in bf16 (1e-5 of the output else), plus c of the sum of
the absolute terms, c from the number of terms
(``ms_deform_attn_bwd_magnitude``). Here: the emulations lie within the
limits, and emulations of broken kernels (K3 without the scale or without
the bias, K1 with its bilinear fractions swapped, K2 with d loc_x on fx's
stencil or d value scattered with two corners' weights swapped) fail them
by more than 10x, as the mutants of ``tools/kernel_mutants.py`` must on
the card.

K3's backward (``csrc/swin_attention_bwd.cu``) rounds where autograd
through the twin rounds in bf16 (q * scale, dP = dO v^T, P before P^T dO,
dS K and its product with the scale, dS^T (q scale)), and in bf16 also
rounds dS, the tensor cores' operand of dq and dK; it sums in f32 in
another order (d bias over each group of windows, then over the groups in
order); its limit allows one bf16 step of the output plus 2^-8 of the
magnitude of the products whose rounded operand may fall the other way
(``window_attention_bwd_magnitude``). Its broken versions drop
rowsum(P o dP) from dS, or leave d bias one group's partial instead of the
sum over the groups.
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


def emulate_k3_bwd(qkv, bias, mask, h, scale, dout, mutant=None, groups=3):
    """K3's backward's arithmetic in qkv's type: q * scale rounded, P in
    f32 (recomputed), dP = dO v^T summed in f32 and rounded, rowsum(P o dP)
    summed over 16-key chunks, dS in f32; in bf16 dS rounded before dq =
    rnd(rnd(dS k) scale) and dk = rnd(dS^T (q scale)) (the tensor-core
    kernel's operand; f32 keeps it), dv = rnd(rnd(P)^T dO); d bias from the
    f32 dS, summed over each of ``groups`` contiguous groups of windows (the
    balanced split) and then over the groups in order. ``mutant``:
    "no_rowsum" (dS = P o dP) or "unsummed" (d bias = the last group's
    partial instead of the sum of the groups)."""
    dt = qkv.dtype

    def rnd(x):
        return x.to(dt).float()

    Bn, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // h
    q, k, v = (qkv[:, :, i * C:(i + 1) * C].reshape(Bn, N, h, hd).float()
               for i in range(3))
    qs = rnd(q * scale)
    do = dout.reshape(Bn, N, h, hd).float()
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k) + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, h, N, N)
             + mask[None, :, None]).reshape(Bn, h, N, N)
    p = torch.softmax(s, -1)
    dp = rnd(torch.einsum("bnhd,bmhd->bhnm", do, v))
    dsum = sum((p[..., j:j + 16] * dp[..., j:j + 16]).sum(-1, keepdim=True)
               for j in range(0, N, 16))
    ds = p * dp if mutant == "no_rowsum" else p * (dp - dsum)
    dsr = rnd(ds) if dt == torch.bfloat16 else ds
    dq = rnd(rnd(torch.einsum("bhnm,bmhd->bnhd", dsr, k)) * scale)
    dk = rnd(torch.einsum("bhnm,bnhd->bmhd", dsr, qs))
    dv = rnd(torch.einsum("bhnm,bnhd->bmhd", rnd(p), do))
    dqkv = torch.cat([t.reshape(Bn, N, C) for t in (dq, dk, dv)], -1)
    cuts = [g * Bn // groups for g in range(groups + 1)]
    partials = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        part = torch.zeros(h, N, N)
        for w in range(a, b):
            part = part + ds[w]
        partials.append(part)
    dbias = partials[-1] if mutant == "unsummed" else sum(partials)
    return dqkv.to(dt), dbias


def _k3_bwd_worst(qkv, bias, mask, h, dout, got):
    """The worst share of its limit over d qkv and d bias."""
    scale = (qkv.shape[2] // 3 // h) ** -0.5
    want = sa.window_attention_bwd_ref(qkv, bias, mask, h, scale, dout)
    mags = sa.window_attention_bwd_magnitude(qkv, bias, mask, h, scale, dout)
    return max(((g.float() - w.float()).abs()
                / sa.window_attention_bwd_limit(w, m, qkv.dtype)).max().item()
               for g, w, m in zip(got, want, mags))


def _k3_bwd_case(N, C, h, ws, dtype):
    qkv, bias, mask = _swin_inputs(N, C, h, ws)
    dout = torch.from_numpy(np.random.default_rng(N + 1).standard_normal(
        (qkv.shape[0], N, C)).astype(np.float32))
    return qkv.to(dtype), bias, mask, dout.to(dtype)


K3_BWD_CASES = [(w, dt) for w in WINDOWS
                for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window,dtype", K3_BWD_CASES)
def test_emulated_k3_backward_lies_within_the_limit(window, dtype, masked):
    N, C, h, ws = window
    qkv, bias, mask, dout = _k3_bwd_case(N, C, h, ws, dtype)
    m = mask if masked else None
    got = emulate_k3_bwd(qkv, bias, m, h, (C // h) ** -0.5, dout)
    assert _k3_bwd_worst(qkv, bias, m, h, dout, got) <= 1.0


@pytest.mark.parametrize("mutant", ["no_rowsum", "unsummed"])
@pytest.mark.parametrize("window,dtype", K3_BWD_CASES)
def test_k3_backward_mutants_fail_the_limit(window, dtype, mutant):
    N, C, h, ws = window
    qkv, bias, mask, dout = _k3_bwd_case(N, C, h, ws, dtype)
    got = emulate_k3_bwd(qkv, bias, mask, h, (C // h) ** -0.5, dout, mutant)
    assert _k3_bwd_worst(qkv, bias, mask, h, dout, got) > 10.0


def test_k3_backward_limit_and_magnitude_definitions():
    """The limit is the forward's formula; the magnitudes are scale M dS
    |k|, M dS^T |q scale|, P^T |dO| and the sum of M dS over the windows,
    M dS = P (|dP| + rowsum(P |dP|)), on whole matrices."""
    N, C, h, ws = WINDOWS[1]
    qkv, bias, mask, dout = _k3_bwd_case(N, C, h, ws, torch.float32)
    scale = (C // h) ** -0.5
    want = sa.window_attention_bwd_ref(qkv, bias, mask, h, scale, dout)
    mags = sa.window_attention_bwd_magnitude(qkv, bias, mask, h, scale, dout)
    for w, m in zip(want, mags):
        for dt in (torch.bfloat16, torch.float32):
            torch.testing.assert_close(sa.window_attention_bwd_limit(w, m, dt),
                                       sa.window_attention_limit(w, m, dt))
    Bn, hd = qkv.shape[0], C // h
    q, k, v = (qkv[:, :, i * C:(i + 1) * C].reshape(Bn, N, h, hd)
               .transpose(1, 2) for i in range(3))
    do = dout.reshape(Bn, N, h, hd).transpose(1, 2)
    s = q @ k.transpose(-1, -2) * scale + bias[None]
    s = (s.reshape(Bn // mask.shape[0], mask.shape[0], h, N, N)
         + mask[None, :, None]).reshape(Bn, h, N, N)
    p = torch.softmax(s, -1)
    dp = (do @ v.transpose(-1, -2)).abs()
    mds = p * (dp + (p * dp).sum(-1, keepdim=True))
    parts = [mds @ k.abs() * scale, mds.transpose(-1, -2) @ (q * scale).abs(),
             p.transpose(-1, -2) @ do.abs()]
    torch.testing.assert_close(mags[0], torch.cat(
        [t.transpose(1, 2).reshape(Bn, N, C) for t in parts], -1),
        rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mags[1], mds.sum(0), rtol=1e-5, atol=1e-5)


def _deform_inputs(seed=0, D=8):
    """Pallas3's level shapes with offsets to 12 px, beyond radius 8 and
    off the border."""
    shapes = ((16, 16), (8, 8), (4, 4))
    B, M, P, L = 2, 2, 2, 3
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


def emulate_k2(value, shapes, loc, attn, grad, radius=None, mutant=None,
               seed=0):
    """K2's arithmetic: per sample, each thread's partial sums of d attn,
    d loc_x and d loc_y over its channel group (one 16-byte vector: 8
    channels in bf16, 4 in f32), then an xor shuffle tree over the head's
    threads (4-way at D = 32 in bf16); d loc = a s W, gated by the clamp;
    d attn rounded to value's type; d value's terms g a w summed in f32 in
    a shuffled order and rounded once. ``mutant``: "loc_x_fx" takes d loc_x
    on fx's stencil, "swap_w01_w10" scatters d value with the (0, 1) and
    (1, 0) corners' weights swapped."""
    B, S, M, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    group = 16 // value.element_size()
    T = D // group  # threads a head
    vf, af = value.float(), attn.float()
    g = grad.float().reshape(B, Q, M, D)
    ref = msdeform._ref_tensor(None, shapes, Q, "cpu") if radius else None
    d_loc = torch.zeros(B, Q, M, L, P, 2)
    d_attn = torch.zeros(B, Q, M, L, P)
    rows, terms = [], []
    head = torch.arange(B)[:, None, None] * S * M + torch.arange(M)
    start = 0
    for lv, (H, W) in enumerate(shapes):
        value_l = vf[:, start:start + H * W].reshape(B, H * W * M, D)
        for p in range(P):
            x = loc[:, :, :, lv, p, 0] * W - 0.5  # [B, Q, M]
            y = loc[:, :, :, lv, p, 1] * H - 0.5
            pass_x = pass_y = torch.ones(B, Q, M, dtype=torch.bool)
            if radius:
                rx, ry = ref[None, :, None, lv, 0], ref[None, :, None, lv, 1]
                pass_x = (x - rx).abs() <= radius
                pass_y = (y - ry).abs() <= radius
                x = rx + torch.clamp(x - rx, -radius, radius)
                y = ry + torch.clamp(y - ry, -radius, radius)
            x0, y0 = torch.floor(x), torch.floor(y)
            fx, fy = x - x0, y - y0
            gx, gy = 1 - fx, 1 - fy
            v, ok, pix = [], [], []
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                xi, yi = (x0 + dx).long(), (y0 + dy).long()
                inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                at = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
                row = (at * M + torch.arange(M)).reshape(B, Q * M, 1)
                got = torch.gather(value_l, 1, row.expand(-1, -1, D))
                v.append(got.reshape(B, Q, M, D) * inside[..., None])
                ok.append(inside)
                pix.append(start + at)
            w = [gy * gx, gy * fx, fy * gx, fy * fx]
            e = lambda t: t[..., None]  # noqa: E731
            sx, tx = (gx, fx) if mutant == "loc_x_fx" else (gy, fy)
            per_channel = (
                g * (e(w[0]) * v[0] + e(w[1]) * v[1] + e(w[2]) * v[2]
                     + e(w[3]) * v[3]),
                g * (e(sx) * (v[1] - v[0]) + e(tx) * (v[3] - v[2])),
                g * (e(gx) * (v[2] - v[0]) + e(fx) * (v[3] - v[1])))
            sums = []
            for t in per_channel:
                t = t.reshape(B, Q, M, T, group)
                part = torch.zeros(B, Q, M, T)
                for c in range(group):  # a thread's channels, in order
                    part = part + t[..., c]
                off = T // 2
                while off:  # __shfl_xor_sync over the head's threads
                    part = part + part[..., torch.arange(T) ^ off]
                    off //= 2
                sums.append(part[..., 0])
            a = af[:, :, :, lv, p]
            d_attn[:, :, :, lv, p] = sums[0]
            d_loc[:, :, :, lv, p, 0] = torch.where(pass_x, a * sums[1] * W, 0.0)
            d_loc[:, :, :, lv, p, 1] = torch.where(pass_y, a * sums[2] * H, 0.0)
            ga = g * e(a)
            if mutant == "swap_w01_w10":
                w[1], w[2] = w[2], w[1]
            for c in range(4):
                keep = ok[c].reshape(-1)
                rows.append((head + pix[c] * M).reshape(-1)[keep])
                terms.append((ga * e(w[c])).reshape(-1, D)[keep])
        start += H * W
    rows, terms = torch.cat(rows), torch.cat(terms)
    order = torch.from_numpy(np.random.default_rng(seed).permutation(len(rows)))
    d_value = torch.zeros(B * S * M, D).index_add_(0, rows[order], terms[order])
    return (d_value.reshape(B, S, M, D).to(value.dtype), d_loc,
            d_attn.to(value.dtype))


def _k2_case(dtype, radius, seed=0):
    """_deform_inputs at the model's head width (D = 32) in ``dtype``, with
    a seeded output gradient."""
    value, shapes, loc, attn = _deform_inputs(seed, D=32)
    rng = np.random.default_rng(seed + 1)
    grad = torch.from_numpy(rng.standard_normal(
        (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3]))
        .astype(np.float32))
    return (value.float().to(dtype), shapes, loc, attn.float().to(dtype),
            grad.to(dtype), radius)


def _k2_worst(value, shapes, loc, attn, grad, radius, got):
    """The worst element's share of ``ms_deform_attn_bwd_limit`` in each
    of d value, d loc and d attn."""
    starts = msdeform.level_starts(shapes)
    args = (value, shapes, starts, loc, attn, grad)
    want = msdeform.ms_deform_attn_bwd_ref(*args, radius=radius)
    mag = msdeform.ms_deform_attn_bwd_magnitude(*args, radius=radius)
    limits = msdeform.ms_deform_attn_bwd_limit(want, mag, value.dtype)
    worst = []
    for a, b, lim in zip(got, want, limits):
        assert a.dtype == b.dtype and a.shape == b.shape
        diff = (a.float() - b.float()).abs()
        worst.append((diff / lim).masked_fill(diff == 0, 0.0).max().item())
    return worst


K2_CASES = [(dt, r) for dt in (torch.bfloat16, torch.float32)
            for r in (None, 8.0)]


@pytest.mark.parametrize("dtype,radius", K2_CASES)
def test_emulated_k2_lies_within_the_limit(dtype, radius):
    case = _k2_case(dtype, radius)
    got = emulate_k2(*case, seed=3)
    assert max(_k2_worst(*case, got)) <= 1.0


@pytest.mark.parametrize("dtype,radius", K2_CASES)
def test_k2_with_loc_x_on_fx_stencil_fails_the_limit(dtype, radius):
    case = _k2_case(dtype, radius)
    worst = _k2_worst(*case, emulate_k2(*case, mutant="loc_x_fx"))
    assert worst[1] > 10.0


@pytest.mark.parametrize("dtype,radius", K2_CASES)
def test_k2_with_w01_w10_swapped_fails_the_limit(dtype, radius):
    case = _k2_case(dtype, radius)
    worst = _k2_worst(*case, emulate_k2(*case, mutant="swap_w01_w10"))
    assert worst[0] > 10.0


def test_k2_magnitudes_sum_absolute_terms():
    """Each magnitude is at least |want|; d value's and d attn's equal it
    where every term is positive (g, attn and value >= 0), and d loc_x's
    where the corners (0, 0) and (1, 0), which enter it negated, are 0."""
    value, shapes, loc, attn, grad, _ = _k2_case(torch.float32, None, seed=2)
    starts = msdeform.level_starts(shapes)
    for r in (None, 8.0):
        args = (value, shapes, starts, loc, attn, grad)
        want = msdeform.ms_deform_attn_bwd_ref(*args, radius=r)
        (mags, terms) = msdeform.ms_deform_attn_bwd_magnitude(*args, radius=r)
        assert terms[1:] == (4 * 32, 4 * 32) and terms[0] > 12
        for m, w in zip(mags, want):
            assert m.dtype == torch.float32
            assert (m >= w.abs() * (1 - 1e-6)).all()
        pos = (value.abs(), shapes, starts, loc, attn, grad.abs())
        want = msdeform.ms_deform_attn_bwd_ref(*pos, radius=r)
        mags = msdeform.ms_deform_attn_bwd_magnitude(*pos, radius=r)[0]
        torch.testing.assert_close(mags[0], want[0])
        torch.testing.assert_close(mags[2], want[2])
    # one sample at (x, y) = (1.25, 2.5) of a 4 x 4 level: d loc_x =
    # W a sum_d g_d (gy (v01 - v00) + fy (v11 - v10)) with v00 = v10 = 0
    shapes = ((4, 4),)
    value = torch.ones(1, 16, 1, 8)
    value[0, [2 * 4 + 1, 3 * 4 + 1]] = 0.0
    loc = torch.tensor([(1.25 + 0.5) / 4, (2.5 + 0.5) / 4]).reshape(
        1, 1, 1, 1, 1, 2)
    attn, grad = torch.full((1, 1, 1, 1, 1), 0.7), torch.rand(1, 1, 8)
    args = (value, shapes, (0,), loc, attn, grad)
    want = msdeform.ms_deform_attn_bwd_ref(*args)[1]
    mag = msdeform.ms_deform_attn_bwd_magnitude(*args)[0][1]
    torch.testing.assert_close(mag[..., 0], want[..., 0])
    assert (mag[..., 1] > want[..., 1].abs()).all()


def _mutants():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "kernel_mutants.py")
    spec = importlib.util.spec_from_file_location("kernel_mutants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(_mutants().MUTANTS))
def test_kernel_mutants_break_text_their_sources_hold_once(name):
    """Each mutant of tools/kernel_mutants.py edits text that its kernel
    source holds exactly once (the script exits on the card otherwise), and
    its check is a function of chip_smoke.py."""
    import chip_smoke
    km = _mutants()
    check, module, edits = km.MUTANTS[name]
    assert callable(getattr(chip_smoke, check))
    for path, old, new in edits:
        with open(f"{km.ROOT}/{path}") as f:
            assert f.read().count(old) == 1, (path, old)
        assert old != new
