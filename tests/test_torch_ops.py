"""psalm_tpu_torch ops against their psalm_tpu counterparts on the CPU.

The same seeded numpy inputs go through the JAX function (the Pallas kernels
in interpret mode) and the port's plain version, which is what the port's
wrapper runs for a CPU tensor. Tolerance: 1e-5 absolute in f32 — both sides
compute the same products; only the order of the sums differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from psalm_tpu.ops.msdeform import ms_deform_attn_xla
from psalm_tpu.ops.msdeform_window import ms_deform_attn_window
from psalm_tpu.ops.msdeform_window_pallas2 import ms_deform_attn_window_pallas2
from psalm_tpu.ops.msdeform_window_pallas3 import ms_deform_attn_window_pallas3
from psalm_tpu.ops.sampling import resize_bilinear as jax_resize_bilinear
from psalm_tpu.ops.swin_attention_pallas import (_xla_reference,
                                                 fused_window_attention)
from psalm_tpu_torch.ops import msdeform, sampling, swin_attention

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-5  # f32, summation order only


def _deform_inputs(shapes, B, M, D, P, off_scale, seed):
    """Sampling locations as reference point + offset (in target-level
    pixels), the layout of tests/test_msdeform_pallas2.py and _pallas3.py."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(seed)
    refs = []
    for (H, W) in shapes:
        ys = (np.arange(H) + 0.5) / H
        xs = (np.arange(W) + 0.5) / W
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    ref = np.concatenate(refs, 0)
    norm = np.array([[w, h] for (h, w) in shapes], np.float32)
    off = rng.uniform(-off_scale, off_scale,
                      size=(B, S, M, L, P, 2)).astype(np.float32)
    loc = (ref[None, :, None, None, None, :]
           + off / norm[None, None, None, :, None, :]).astype(np.float32)
    val = rng.randn(B, S, M, D).astype(np.float32)
    attn = rng.rand(B, S, M, L, P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    return val, loc, attn


def _port(val, shapes, loc, attn, radius=None):
    out = msdeform.ms_deform_attn_ref(
        torch.from_numpy(val), shapes, msdeform.level_starts(shapes),
        torch.from_numpy(loc), torch.from_numpy(attn), radius=radius)
    return out.numpy()


# pallas2's shapes (B=2, M=8, D=16, L=3, P=4, r=2, offsets to 1.5 r) and
# pallas3's (16/8/4 levels, M=2, D=8, P=2, r=8, offsets to 12 px: beyond r and
# off the image border)
PALLAS2 = dict(shapes=((4, 4), (8, 8), (16, 16)), B=2, M=8, D=16, P=4,
               radius=2.0, off_scale=3.0, tile=8)
PALLAS3 = dict(shapes=((16, 16), (8, 8), (4, 4)), B=2, M=2, D=8, P=2,
               radius=8.0, off_scale=12.0, tile=4)


@pytest.mark.parametrize("case", [PALLAS2, PALLAS3], ids=["p2", "p3"])
def test_msdeform_exact_matches_xla(case):
    val, loc, attn = _deform_inputs(case["shapes"], case["B"], case["M"],
                                    case["D"], case["P"], case["off_scale"], 0)
    want = ms_deform_attn_xla(jnp.asarray(val), case["shapes"],
                              jnp.asarray(loc), jnp.asarray(attn))
    got = _port(val, case["shapes"], loc, attn)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case,impl", [
    (PALLAS2, "window"), (PALLAS2, "pallas2"),
    (PALLAS3, "window"), (PALLAS3, "pallas2"), (PALLAS3, "pallas3"),
], ids=["p2-window", "p2-pallas2", "p3-window", "p3-pallas2", "p3-pallas3"])
def test_msdeform_clamped_matches_window(case, impl):
    shapes, r, tile = case["shapes"], case["radius"], case["tile"]
    val, loc, attn = _deform_inputs(shapes, case["B"], case["M"], case["D"],
                                    case["P"], case["off_scale"], 3)
    args = (jnp.asarray(val), shapes, jnp.asarray(loc), jnp.asarray(attn))
    if impl == "window":
        want = ms_deform_attn_window(*args, tile=tile, radius=r)
    elif impl == "pallas2":
        want = ms_deform_attn_window_pallas2(*args, tile=tile, radius=r,
                                             interpret=True)
    else:
        want = ms_deform_attn_window_pallas3(*args, tile=tile, radius=r,
                                             interpret=True)
    got = _port(val, shapes, loc, attn, radius=r)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    # the clamp is live: the unclamped result differs
    assert np.abs(_port(val, shapes, loc, attn) - got).max() > 1e-3


def test_reference_grid_matches_window_ref_grid():
    from psalm_tpu.ops.msdeform_window import _ref_grid
    shapes = ((6, 10), (3, 5))
    grid = msdeform.reference_grid(shapes)
    s = 0
    for hq, wq in shapes:
        for lv, (hv, wv) in enumerate(shapes):
            ry, rx = _ref_grid(hq, wq, hq, wq, hv, wv)  # one tile: raster order
            np.testing.assert_array_equal(grid[s:s + hq * wq, lv, 0], rx[0])
            np.testing.assert_array_equal(grid[s:s + hq * wq, lv, 1], ry[0])
        s += hq * wq


def _swin_inputs(seed=0, Bn=6, N=16, C=32, h=4, nW=3):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(Bn, N, 3 * C).astype(np.float32)
    bias = rng.randn(h, N, N).astype(np.float32)
    mask = (rng.randn(nW, N, N) * 2).astype(np.float32)
    return qkv, bias, mask


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_pallas_and_xla(masked):
    qkv, bias, mask = _swin_inputs(seed=1)
    h, scale = 4, 0.25
    Bn, N, _ = qkv.shape
    nW = mask.shape[0]
    m = mask if masked else None
    got = swin_attention.window_attention_ref(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        torch.from_numpy(m) if masked else None, h, scale).numpy()
    pallas = fused_window_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                    jnp.asarray(m) if masked else None, h,
                                    scale, interpret=True)
    mf = (np.broadcast_to(mask[None], (Bn // nW, nW, N, N)).reshape(Bn, N, N)
          if masked else None)
    xla = _xla_reference(jnp.asarray(qkv), jnp.asarray(bias),
                         jnp.asarray(mf) if masked else None, h, scale)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=0, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_pallas_and_xla_at_swin_b_window(masked):
    """Swin-B's window: N = 144 tokens (12x12), 4 heads of 32 (stage 0), the
    shift mask of a 24x24 map (4 windows, the port's shift_attn_mask equal
    to JAX's), f32."""
    from psalm_tpu.models.swin import _shift_attn_mask
    from psalm_tpu_torch.models.swin import shift_attn_mask
    ws, C, h = 12, 128, 4
    mask = shift_attn_mask(2 * ws, 2 * ws, ws, ws // 2)
    np.testing.assert_array_equal(mask, _shift_attn_mask(2 * ws, 2 * ws, ws,
                                                         ws // 2))
    nW, N = mask.shape[0], ws * ws
    rng = np.random.default_rng(12)
    qkv = rng.standard_normal((nW, N, 3 * C)).astype(np.float32)
    bias = rng.standard_normal((h, N, N)).astype(np.float32)
    scale = (C // h) ** -0.5
    m = mask if masked else None
    got = swin_attention.window_attention_ref(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        torch.from_numpy(m) if masked else None, h, scale).numpy()
    pallas = fused_window_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                    jnp.asarray(m) if masked else None, h,
                                    scale, interpret=True)
    xla = _xla_reference(jnp.asarray(qkv), jnp.asarray(bias),
                         jnp.asarray(m) if masked else None, h, scale)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=0, atol=ATOL)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((8, 12), (16, 24)),    # up x2
    ((16, 24), (8, 12)),    # down x2
    ((32, 32), (8, 8)),     # down x4
    ((64, 32), (8, 4)),     # down x8
    ((10, 14), (23, 9)),    # non-integer ratios, up and down
])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)
    want = jax_resize_bilinear(jnp.asarray(x), out_hw)
    got = sampling.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
