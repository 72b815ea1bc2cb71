"""The bf16 limit of K5 and its backward (``flash_attention.bf16_limit``),
held against a plain-torch emulation of the bf16 kernels' arithmetic.

The tensor-core kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) round P to bf16 before P v and P^T dO, and
dS before dS^T q and dS k, as the stock TPU kernel does
(``jax/experimental/pallas/ops/tpu/flash_attention.py``:471, :900, :918,
:1251-1258); the plain versions keep both in f32. Their outputs may then
differ by one bf16 step of the output plus 2^-8 of the rounded product's
magnitude (``flash_attention_magnitude``, ``flash_attention_bwd_magnitude``).
Here, at small sizes on the CPU: the emulation lies within that limit, and
an emulation with the softmax at the wrong temperature (log2 e dropped from
the logits' scale) or a backward without D = rowsum(dO O) does not. The
kernels themselves are held to the same limit on the card by
``chip_smoke.py`` and the ``gpu`` tests of ``test_torch_package.py``.
"""

import math

import numpy as np
import pytest
import torch

from psalm_tpu_torch.ops import flash_attention as fa

LOG2E = 1.4426950408889634
TILE = 64  # keys per online-softmax step, as the forward kernel walks them
CASES = [(hd, L, causal) for hd in fa.HEAD_DIMS for L in (37, 200)
         for causal in (True, False)]


def _inputs(L, hd, n=4, seed=0):
    rng = np.random.default_rng(seed + 7 * L + hd)
    return [torch.from_numpy(rng.standard_normal((1, 2, L, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(n)]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def emulate_forward(q, k, v, causal, sm_scale, log2e=LOG2E):
    """The bf16 forward kernel's arithmetic: f32 logits of the bf16 inputs;
    per tile of 64 keys an online softmax in exp2 of log2e-scaled logits
    (running max and f32 denominator); P, relative to the running max,
    rounded to bf16 before P v; out = O / l rounded to bf16."""
    B, h, L, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = sm_scale * log2e
    m = torch.full((B, h, L), -math.inf)
    den = torch.zeros(B, h, L)
    o = torch.zeros(B, h, L, hd)
    rows = torch.arange(L)
    for j0 in range(0, L, TILE):
        j1 = min(L, j0 + TILE)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, j0:j1])
        if causal:
            later = torch.arange(j0, j1)[None, :] > rows[:, None]
            s = s.masked_fill(later, -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(s * scale_log2 - base[..., None])
        den = den * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", _bf16(p),
                                               vf[:, :, j0:j1])
        m = m_new
    return (o / den[..., None]).to(q.dtype)


def emulate_backward(q, k, v, out, lse, dout, causal, sm_scale,
                     with_delta=True):
    """The bf16 backward kernels' arithmetic: P from the log-sum-exp in
    exp2, dP and D = rowsum(dO O) in f32, dS = P (dP - D); P rounded to
    bf16 before P^T dO, dS before dS^T q and dS k; the scale applied once
    at the end; the outputs rounded to bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    L = q.shape[2]
    p = torch.exp2(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale * LOG2E
                   - lse[..., None] * LOG2E)
    if causal:
        p = p.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1), 0.0)
    delta = (dof * out.float()).sum(-1) if with_delta else torch.zeros_like(lse)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", _bf16(p), dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", _bf16(ds), qf) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", _bf16(ds), kf) * sm_scale
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _worst_forward(q, k, v, causal, got):
    """Largest |got - want| over its bf16 limit (atol 1e-5, as on the card)."""
    kw = dict(causal=causal, sm_scale=q.shape[-1] ** -0.5)
    want = fa.flash_attention_ref(q, k, v, **kw).float()
    limit = fa.bf16_limit(want, fa.flash_attention_magnitude(q, k, v, **kw),
                          1e-5)
    return ((got.float() - want).abs() / limit).max().item()


def _backward_case(L, hd, causal, with_delta=True):
    """(worst of dq, dk, dv over their bf16 limits): the emulated backward
    against the plain one, both from the emulated forward's out and the
    plain log-sum-exp (atol 1e-5 of the largest |want|, as on the card)."""
    q, k, v, do = _inputs(L, hd)
    scale = hd ** -0.5
    out = emulate_forward(q, k, v, causal, scale)
    lse = fa._ref_forward(q, k, v, causal, scale, with_lse=True)[1]
    kw = dict(causal=causal, sm_scale=scale)
    got = emulate_backward(q, k, v, out, lse, do, causal, scale, with_delta)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    mags = fa.flash_attention_bwd_magnitude(q, k, v, out, lse, do, **kw)
    worst = []
    for a, b, mag in zip(got, want, mags):
        b = b.float()
        limit = fa.bf16_limit(b, mag, 1e-5 * b.abs().max())
        worst.append(((a.float() - b).abs() / limit).max().item())
    return worst


@pytest.mark.parametrize("hd,L,causal", CASES)
def test_emulated_bf16_forward_lies_within_the_limit(hd, L, causal):
    q, k, v = _inputs(L, hd, n=3)
    got = emulate_forward(q, k, v, causal, hd ** -0.5)
    assert _worst_forward(q, k, v, causal, got) <= 1.0


@pytest.mark.parametrize("hd,L,causal", CASES)
def test_emulated_bf16_backward_lies_within_the_limit(hd, L, causal):
    assert max(_backward_case(L, hd, causal)) <= 1.0


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_softmax_at_the_wrong_temperature_fails_the_limit(hd):
    """log2 e dropped from the scale: exp2 of the plain logits, a softmax
    at ln 2 times the temperature."""
    q, k, v = _inputs(200, hd, n=3)
    got = emulate_forward(q, k, v, False, hd ** -0.5, log2e=1.0)
    assert _worst_forward(q, k, v, False, got) > 10.0


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_backward_without_delta_fails_the_limit(hd):
    worst = _backward_case(200, hd, False, with_delta=False)
    assert max(worst) > 10.0


@pytest.mark.parametrize("causal", [True, False])
def test_magnitudes_are_products_of_absolute_values(causal):
    """The magnitudes against their definitions on whole [L, L] matrices:
    P |v|, and with dS = P (dO v^T - D): |dS| |k| scale, |dS|^T |q| scale,
    P^T |dO|."""
    L, hd = 37, 32
    q, k, v, do = (t.float() for t in _inputs(L, hd))
    scale = hd ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        logits = logits.masked_fill(
            torch.ones(L, L, dtype=torch.bool).triu(1), -math.inf)
    p = torch.softmax(logits, -1)
    kw = dict(causal=causal, sm_scale=scale)
    torch.testing.assert_close(fa.flash_attention_magnitude(q, k, v, **kw),
                               p @ v.abs(), rtol=1e-5, atol=1e-6)
    out, lse = fa._ref_forward(q, k, v, causal, scale, with_lse=True)
    ds = p * (do @ v.transpose(-1, -2) - (do * out).sum(-1, keepdim=True))
    mq, mk, mv = fa.flash_attention_bwd_magnitude(q, k, v, out, lse, do, **kw)
    torch.testing.assert_close(mq, ds.abs() @ k.abs() * scale, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(mk, ds.abs().transpose(-1, -2) @ q.abs()
                               * scale, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mv, p.transpose(-1, -2) @ do.abs(), rtol=1e-5,
                               atol=1e-6)
