"""The training slice's ops against psalm_tpu on the CPU, in f32: the
gradients of the deformable sampler (K2's plain twin) and of K5 (its plain
backward), point_sample's gradient, the learning-rate schedule, the AdamW
step and the conversation loss.

Tolerances:
  * K2's plain twin against ``jax.vjp`` of ``ms_deform_attn_xla`` (and, with
    a radius, of ``ms_deform_attn_window``'s manual VJP): each gradient
    within 1e-5 of its largest magnitude. Offsets are pushed 0.05 pixel away
    from whole pixels and from the clip at +-radius: there AD of floor and
    clip takes one side and the other side's derivative differs
    (tests/test_golden_reference.py:1684-1697).
  * K5's plain backward against ``jax.vjp`` of the stock TPU kernel in
    interpret mode: within 1e-5 of each gradient's largest magnitude
    (unit-variance inputs; f32 sums in another order).
  * point_sample's feature gradient, the schedule, AdamW and the loss: 1e-6
    relative or absolute as stated (the same f32 arithmetic on both sides).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as stock_flash_attention)

from psalm_tpu.ops.msdeform import ms_deform_attn_xla
from psalm_tpu.ops.msdeform_window import ms_deform_attn_window
from psalm_tpu.ops.sampling import point_sample_mmgrad
from psalm_tpu.train.train import llm_ce_loss as jllm_ce_loss
from psalm_tpu.train.train_step import make_optimizer as jmake_optimizer
from psalm_tpu_torch.ops import flash_attention as fa
from psalm_tpu_torch.ops import msdeform
from psalm_tpu_torch.ops.sampling import point_sample
from psalm_tpu_torch.train.train import llm_ce_loss
from psalm_tpu_torch.train.train_step import (make_optimizer,
                                              warmup_cosine_schedule)

torch.backends.cuda.matmul.allow_tf32 = False

SHAPES = ((4, 4), (8, 8), (16, 16))


def _off_kinks(x, step=1.0, margin=0.05):
    """x moved to at least ``margin`` from every multiple of ``step``."""
    frac = np.mod(x, step)
    return np.where(frac < margin, x + margin,
                    np.where(frac > step - margin, x - margin, x))


def deform_case(seed, shapes, max_off, radius=None, B=1, M=4, D=16, P=4):
    """Encoder inputs (Q == S): pixel-centre reference points plus offsets of
    up to ``max_off`` target-level pixels, some off the image, away from
    whole-pixel coordinates and from +-radius; and an output gradient."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    ref = np.concatenate([np.stack(np.meshgrid(
        (np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H,
        indexing="xy"), -1).reshape(-1, 2) for H, W in shapes], 0)
    S = ref.shape[0]
    off = rng.uniform(-max_off, max_off, size=(B, S, M, L, P, 2))
    # pixel coordinate = index + offset: keep the offset's fraction off 0
    off = _off_kinks(off)
    if radius is not None:
        near = np.abs(np.abs(off) - radius) < 0.05
        off = np.where(near, off * (1 - 0.1 / radius), off)
    norm = np.array([[w, h] for (h, w) in shapes], np.float64)
    loc = (ref[None, :, None, None, None, :]
           + off / norm[None, None, None, :, None, :]).astype(np.float32)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    attn = rng.uniform(0, 1, size=(B, S, M, L, P)).astype(np.float32)
    attn /= attn.reshape(B, S, M, -1).sum(-1).reshape(B, S, M, 1, 1)
    g = rng.standard_normal((B, S, M * D)).astype(np.float32)
    return value, loc, attn, g


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max err {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("radius", [None, 2.0])
def test_k2_plain_twin_matches_jax_vjp(radius):
    value, loc, attn, g = deform_case(3, SHAPES, max_off=6.0, radius=radius)
    args = tuple(map(jnp.asarray, (value, loc, attn)))
    if radius is None:
        fn = lambda v, l, a: ms_deform_attn_xla(v, SHAPES, l, a)  # noqa: E731
    else:
        fn = lambda v, l, a: ms_deform_attn_window(  # noqa: E731
            v, SHAPES, l, a, tile=8, radius=radius, custom_vjp=True)
    out, vjp = jax.vjp(fn, *args)
    want = vjp(jnp.asarray(g))
    got = msdeform.ms_deform_attn_bwd(
        *map(torch.from_numpy, (value,)), SHAPES,
        msdeform.level_starts(SHAPES), torch.from_numpy(loc),
        torch.from_numpy(attn), torch.from_numpy(g), radius=radius)
    for name, gt, w in zip(("value", "loc", "attn"), got, want):
        _rel_close(gt.numpy(), w, 1e-5)
    # the case reaches off the image, and the radius clips some offsets
    x = loc[..., 0] * np.array([w for _, w in SHAPES])[:, None] - 0.5
    assert (x < -1).any()
    if radius is not None:
        d_loc = got[1].numpy()
        assert (d_loc == 0).any() and (np.asarray(want[1]) == 0).any()
        np.testing.assert_array_equal(d_loc == 0, np.asarray(want[1]) == 0)


def test_k2_gradient_flows_through_ms_deform_attn():
    """Autograd through the CPU wrapper is the plain twin, and the output's
    value, loc and attn all receive a gradient."""
    value, loc, attn, g = deform_case(4, SHAPES, max_off=3.0, radius=1.5)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (value, loc, attn)]
    out = msdeform.ms_deform_attn(leaves[0], SHAPES, None, leaves[1],
                                  leaves[2], radius=1.5)
    out.backward(torch.from_numpy(g))
    want = msdeform.ms_deform_attn_bwd_ref(
        *map(torch.from_numpy, (value,)), SHAPES, None,
        torch.from_numpy(loc), torch.from_numpy(attn), torch.from_numpy(g),
        radius=1.5)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def _qkv(seed, B, h, L, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, L, hd)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("L,causal,hd", [(128, True, 32), (256, False, 32),
                                         (256, True, 128), (128, False, 128)])
def test_k5_plain_backward_matches_stock_kernel_vjp(L, causal, hd):
    q, k, v, do = _qkv(L + hd, 1, 2, L, hd)
    scale = hd ** -0.5
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: stock_flash_attention(
            a, b, c, causal=causal, sm_scale=scale),
            *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, sm_scale=scale)
    out.backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, want):
        _rel_close(leaf.grad.numpy(), w, 1e-5)


def test_k5_plain_backward_on_valid_rows_of_a_padded_causal_sequence():
    """Phi's flash branch pads L to a multiple of 128 for the stock kernel;
    the port takes L = 200 as it is. Causal, with zero cotangents on the
    pad rows: the valid rows' dq, dk and dv agree."""
    L, Lp, hd = 200, 256, 64
    q, k, v, do = _qkv(9, 1, 2, L, hd)
    pad = ((0, 0), (0, 0), (0, Lp - L), (0, 0))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: stock_flash_attention(
            a, b, c, causal=True, sm_scale=hd ** -0.5),
            *(jnp.asarray(np.pad(t, pad)) for t in (q, k, v)))
        want = vjp(jnp.asarray(np.pad(do, pad)))
    got = fa.flash_attention_bwd_ref(
        *map(torch.from_numpy, (q, k, v)),
        *_forward_with_lse(q, k, v, hd), torch.from_numpy(do), causal=True,
        sm_scale=hd ** -0.5)
    for gt, w in zip(got, want):
        _rel_close(gt.numpy(), np.asarray(w)[:, :, :L], 1e-5)


def _forward_with_lse(q, k, v, hd):
    out, lse = fa._ref_forward(*map(torch.from_numpy, (q, k, v)), True,
                               hd ** -0.5, with_lse=True)
    return out, lse


def test_k5_plain_backward_is_chunked_over_queries(monkeypatch):
    """Chunks of 7 query rows give the one-chunk gradients, and the forward's
    log-sum-exp is the logits' logsumexp."""
    q, k, v, do = map(torch.from_numpy, _qkv(5, 2, 3, 30, 32))
    for causal in (True, False):
        out, lse = fa._ref_forward(q, k, v, causal, 0.2, with_lse=True)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.2
        if causal:
            logits = logits.masked_fill(torch.ones(30, 30).triu(1).bool(),
                                        float("-inf"))
        torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                                   rtol=0, atol=1e-5)
        whole = fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                           causal=causal, sm_scale=0.2)
        monkeypatch.setattr(fa, "_REF_CHUNK_BYTES", 4 * 2 * 3 * 30 * 7)
        chunked = fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                             causal=causal, sm_scale=0.2)
        monkeypatch.undo()
        for a, b in zip(chunked, whole):  # dk and dv summed in another order
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_point_sample_feature_gradient_matches_jax(align_corners):
    """Autograd through point_sample's gathers against JAX's dense-matmul
    VJP of point_sample_mmgrad; the points get no gradient on either side."""
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, size=(2, 40, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 40, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda f, c: point_sample_mmgrad(
        f, c, align_corners=align_corners), jnp.asarray(feat),
        jnp.asarray(coords))
    want_feat, want_coords = vjp(jnp.asarray(cot))
    f = torch.from_numpy(feat).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    point_sample(f, c, align_corners=align_corners).backward(
        torch.from_numpy(cot))
    _rel_close(f.grad.numpy(), want_feat, 1e-6)
    assert c.grad is None and not np.asarray(want_coords).any()


@pytest.mark.parametrize("total,ratio", [(100, 0.03), (1000, 0.03), (10, 0.0)])
def test_schedule_matches_optax(total, ratio):
    warmup = max(int(total * ratio), 1)
    want = optax.warmup_cosine_decay_schedule(0.0, 6e-5, warmup, total, 0.0)
    got = warmup_cosine_schedule(6e-5, total, ratio)
    for step in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1,
                 total, total + 5):
        assert abs(got(step) - float(want(step))) <= 1e-6 * 6e-5, step
    assert got(0) == 0.0


@pytest.mark.parametrize("weight_decay,grad_clip", [(0.0, None), (0.05, 0.5)])
def test_adamw_step_matches_optax(weight_decay, grad_clip):
    """Three updates of psalm_tpu's optax chain and of the port's Optimizer
    on the same parameters and gradients (one gradient leaf None on the
    port's side, zeros on JAX's), with the clip above and below the norm."""
    rng = np.random.default_rng(8)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jmake_optimizer(1e-2, 20, 0.1, weight_decay, grad_clip=grad_clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = make_optimizer(list(tparams.values()), 1e-2, 20, 0.1, weight_decay,
                         grad_clip=grad_clip)
    for step in range(3):
        grads = {k: (rng.standard_normal(s).astype(np.float32)
                     * (0.1 if step == 1 else 1.0)) for k, s in shapes.items()}
        grads["c"] *= 0.0
        want_norm = float(optax.global_norm(grads))
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                               state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = None if k == "c" else torch.tensor(grads[k])
        norm = opt.step()
        assert abs(float(norm) - want_norm) <= 1e-6 * want_norm
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6)
    assert opt.count == 3


def test_llm_ce_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 7))
    labels[0, :3] = -100
    labels[1, 5:] = -100
    want = float(jllm_ce_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(llm_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
