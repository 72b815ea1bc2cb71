"""psalm_tpu_torch as a package: no JAX and nothing of psalm_tpu behind it,
the kernel wrappers' dispatch (the plain version for a CPU tensor, the
kernel or an error for any other), the nvcc commands, K4's split plan, and
the kernels against their plain versions on a card (marked ``gpu``; they
skip where there is none)."""

import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import psalm_tpu_torch
from psalm_tpu_torch.ops import (_build, flash_attention, int4_matvec,
                                 msdeform, swin_attention)


def test_no_jax_behind_the_package():
    mods = [m.name for m in pkgutil.walk_packages(psalm_tpu_torch.__path__,
                                                  "psalm_tpu_torch.")]
    for m in ("eval.runner", "serve.model_worker", "models.generation",
              "models.builder", "ops.int4_matvec", "config", "data.splicer",
              "data.datasets", "train.criterion", "train.train_step",
              "train.train", "native", "data.coco_rle", "data.conversation",
              "data.tokenization", "data.mappers", "eval.metrics",
              "eval.artifacts", "eval.panoptic_segmentation",
              "eval.semantic_segmentation", "eval.instance_segmentation",
              "eval.referring_segmentation", "eval.region_segmentation",
              "eval.eval_grefcoco", "eval.cityscapes_instance"):
        assert f"psalm_tpu_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax')\n"
            "       or m == 'psalm_tpu' or m.startswith('psalm_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _deform_args(device="cpu", dtype=torch.float32):
    shapes = ((4, 6), (2, 3))
    S = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(0)
    value = torch.randn(1, S, 2, 8, generator=g).to(device, dtype)
    loc = torch.rand(1, S, 2, 2, 3, 2, generator=g).to(device)
    attn = torch.softmax(torch.randn(1, S, 2, 6, generator=g), -1)
    attn = attn.reshape(1, S, 2, 2, 3).to(device, dtype)
    return value, shapes, msdeform.level_starts(shapes), loc, attn


def _swin_args(device="cpu", dtype=torch.float32, N=16, C=32, h=2):
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(4, N, 3 * C, generator=g).to(device, dtype)
    bias = torch.randn(h, N, N, generator=g).to(device)
    mask = torch.randn(2, N, N, generator=g).to(device)
    return qkv, bias, mask, h, 0.25


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    n1, n3 = msdeform.LAUNCHES, swin_attention.LAUNCHES
    args = _deform_args()
    for radius in (None, 1.5):
        got = msdeform.ms_deform_attn(*args, radius=radius)
        want = msdeform.ms_deform_attn_ref(*args, radius=radius)
        assert torch.equal(got, want)
    sargs = _swin_args()
    assert torch.equal(swin_attention.window_attention(*sargs),
                       swin_attention.window_attention_ref(*sargs))
    assert (msdeform.LAUNCHES, swin_attention.LAUNCHES) == (n1, n3)


def test_other_devices_reach_the_kernel_loader(monkeypatch):
    def loader():
        raise RuntimeError("kernel loader reached")

    monkeypatch.setattr(_build, "library", loader)
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        msdeform.ms_deform_attn(*_deform_args("meta"))
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        swin_attention.window_attention(*_swin_args("meta"))


def test_wrappers_check_inputs_before_launch(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: None)
    n1, n3 = msdeform.LAUNCHES, swin_attention.LAUNCHES
    with pytest.raises(ValueError, match="meta"):
        msdeform.ms_deform_attn(*_deform_args("meta"))
    with pytest.raises(ValueError, match="meta"):
        swin_attention.window_attention(*_swin_args("meta"))
    assert (msdeform.LAUNCHES, swin_attention.LAUNCHES) == (n1, n3)


def test_nvcc_command_targets_sm90a():
    out = _build.library_path()
    cmd = _build.nvcc_command("nvcc", _build.sources(), out)
    assert cmd[0] == "nvcc"
    for flag in ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    srcs = {p.name for p in _build.sources()}
    assert {"msdeform.cu", "swin_attention.cu"} <= srcs
    assert all(str(_build.CSRC_DIR / s) in cmd for s in srcs)
    assert out.parent == _build.PACKAGE_DIR.parent / "build" / "psalm_tpu_torch"
    assert _build.source_hash() in out.name


def test_nvcc_compiles_each_source_on_its_own_for_sm90a():
    srcs = _build.sources()
    assert {"int4_matvec.cu", "flash_attention.cu"} <= {p.name for p in srcs}
    assert set(_build.SIGNATURES) >= {"psalm_flash_attention_fwd"}
    for src in srcs:
        obj = _build.BUILD_DIR / f"{src.stem}.o"
        cmd = _build.nvcc_command("nvcc", [src], obj, compile_only=True)
        for flag in ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                     "-O3", "-Xcompiler", "-fPIC", "-c"):
            assert flag in cmd
        assert "-shared" not in cmd
        assert cmd[cmd.index("-o") + 1] == str(obj) and cmd[-1] == str(src)


def _int4_args(device="cpu", dtype=torch.float32, B=3, K=256, N=128, group=64):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, K, generator=g).to(device, dtype)
    packed = torch.randint(-128, 128, (K // 2, N), generator=g,
                           dtype=torch.int8).to(device)
    scale = torch.rand(K // group, N, generator=g).to(device)
    return x, packed, scale, group


def test_int4_cpu_takes_the_plain_version_and_counts_no_launch():
    n = int4_matvec.LAUNCHES
    args = _int4_args()
    assert torch.equal(int4_matvec.int4_matvec(*args),
                       int4_matvec.int4_matvec_ref(*args))
    assert int4_matvec.LAUNCHES == n


def test_int4_other_devices_reach_the_kernel_loader(monkeypatch):
    def loader():
        raise RuntimeError("kernel loader reached")

    monkeypatch.setattr(_build, "library", loader)
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        int4_matvec.int4_matvec(*_int4_args("meta"))


def test_int4_wrapper_checks_inputs_before_launch(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: None)
    n = int4_matvec.LAUNCHES
    with pytest.raises(ValueError, match="meta"):
        int4_matvec.int4_matvec(*_int4_args("meta"))
    assert int4_matvec.LAUNCHES == n


def _plan_cover(B, K, N, group):
    """The rows and columns of one plan's launch: (packed row -> times
    covered, rank of each row, column -> times covered)."""
    cluster, tc, rows = int4_matvec.plan(B, K, N, group)
    half = K // 2
    piece = (int4_matvec.PIECE_ROWS if group % int4_matvec.PIECE_ROWS == 0
             else 1)
    row_hits, rank_of = np.zeros(half, int), np.full(half, -1)
    for rank in range(cluster):
        r0 = rank * rows
        n_rows = max(0, min(rows, half - r0))
        assert n_rows > 0, "every rank holds rows"
        for p in range(n_rows // piece):  # a thread's piece, in one group
            lo = r0 + p * piece
            assert lo // group == (lo + piece - 1) // group
            row_hits[lo:lo + piece] += 1
            rank_of[lo:lo + piece] = rank
    cols = int4_matvec.COLUMNS_PER_THREAD * tc
    col_hits = np.zeros(N, int)
    for block in range(N // cols):
        for t in range(tc):
            c0 = block * cols + int4_matvec.COLUMNS_PER_THREAD * t
            col_hits[c0:c0 + int4_matvec.COLUMNS_PER_THREAD] += 1
    return (cluster, tc, rows), row_hits, rank_of, col_hits


@pytest.mark.parametrize("B,K,N", [(1, 2048, 2048), (4, 2048, 8192),
                                   (16, 8192, 2048), (3, 256, 128)])
def test_int4_plan_covers_the_rows_in_whole_groups(B, K, N):
    """K4's cluster cut: at most 8 ranks, each a whole number of groups,
    every packed row and every column covered once; at Phi's shapes every
    thread takes at most one piece."""
    (cluster, tc, rows), row_hits, rank_of, col_hits = _plan_cover(B, K, N,
                                                                   64)
    assert 1 <= cluster <= int4_matvec.MAX_CLUSTER and rows % 64 == 0
    assert (row_hits == 1).all() and (col_hits == 1).all()
    assert (np.diff(rank_of) >= 0).all()  # ranks hold consecutive rows
    assert tc & (tc - 1) == 0 and 1 <= tc <= 32
    if K >= 2048:  # Phi's linears: the whole matrix in flight at once
        assert rows // int4_matvec.PIECE_ROWS <= int4_matvec.THREADS // tc
        assert cluster == int4_matvec.MAX_CLUSTER


@pytest.mark.parametrize("B,K,N,group", [(1, 24, 128, 4), (2, 96, 256, 48),
                                         (5, 4096, 384, 64),
                                         (16, 1024, 4096, 32)])
def test_int4_plan_covers_odd_groups_and_counts(B, K, N, group):
    """The same cover for groups that 8 does not divide (pieces of one
    row), fewer groups than 8 ranks, and row counts between powers of
    two; the plan is cached per shape."""
    assert int4_matvec.int4_matvec_supported(B, K, N, group)
    (cluster, _, rows), row_hits, _, col_hits = _plan_cover(B, K, N, group)
    assert cluster <= min(8, K // 2 // group) and rows % group == 0
    assert (row_hits == 1).all() and (col_hits == 1).all()
    assert int4_matvec.plan(B, K, N, group) is int4_matvec.plan(B, K, N, group)


def _flash_args(device="cpu", dtype=torch.float32, B=1, h=2, L=37, hd=32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, h, L, hd, generator=g).to(device, dtype)
            for _ in range(3)]


def test_flash_cpu_takes_the_plain_version_and_counts_no_launch():
    n = (flash_attention.LAUNCHES, flash_attention.CAUSAL_LAUNCHES)
    for causal in (True, False):
        q, k, v = _flash_args()
        assert torch.equal(
            flash_attention.flash_attention(q, k, v, causal=causal, sm_scale=0.3),
            flash_attention.flash_attention_ref(q, k, v, causal=causal,
                                                sm_scale=0.3))
    assert (flash_attention.LAUNCHES, flash_attention.CAUSAL_LAUNCHES) == n


def test_flash_other_devices_reach_the_kernel_loader(monkeypatch):
    def loader():
        raise RuntimeError("kernel loader reached")

    monkeypatch.setattr(_build, "library", loader)
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        flash_attention.flash_attention(*_flash_args("meta"), causal=True,
                                        sm_scale=1.0)


@pytest.mark.parametrize("bad,match", [
    ({}, "meta"), (dict(hd=16), "head dim 16"), (dict(dtype=torch.float16),
                                                 "float16")])
def test_flash_wrapper_checks_inputs_before_launch(monkeypatch, bad, match):
    """The wrapper refuses what the kernel lacks (a head dim, a dtype, a
    non-CUDA tensor) before any launch: no quiet plain-version route."""
    monkeypatch.setattr(_build, "library", lambda: None)
    n = flash_attention.LAUNCHES
    with pytest.raises((ValueError, TypeError), match=match):
        flash_attention.flash_attention(*_flash_args("meta", **bad),
                                        causal=True, sm_scale=1.0)
    assert flash_attention.LAUNCHES == n


def test_flash_wrapper_refuses_bf16_off_a_16_byte_boundary(monkeypatch):
    """The bf16 tensor-core kernels copy 16-byte pieces of each row: a bf16
    input that starts elsewhere is refused before any launch."""
    monkeypatch.setattr(_build, "library", lambda: None)
    n = flash_attention.LAUNCHES
    q, k, v = _flash_args("meta", torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, device="meta",
                          dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention.flash_attention(shifted, k, v, causal=True,
                                        sm_scale=1.0)
    assert flash_attention.LAUNCHES == n


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret "
                    "mode; chip_smoke.py checks them on the H100")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_kernel_matches_plain_version_on_the_card(dtype):
    """K4 against int4_matvec_ref: exact on one-hot rows with power-of-two
    scales, and within 1e-5 of the output's magnitude on random values (f32
    sums in another order)."""
    _require_card()
    for B, K, N in ((1, 256, 128), (5, 2048, 384), (16, 4096, 256)):
        x, packed, scale, group = _int4_args("cuda", dtype, B, K, N)
        got = int4_matvec.int4_matvec(x, packed, scale, group)
        want = int4_matvec.int4_matvec_ref(x, packed, scale, group)
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (B, K, N, err)
        onehot = torch.zeros(B, K, device="cuda", dtype=dtype)
        onehot[torch.arange(B), torch.arange(B) * 7 % K] = 1
        pow2 = torch.exp2(torch.randint(-4, 3, scale.shape, device="cuda")
                          .float())
        assert torch.equal(int4_matvec.int4_matvec(onehot, packed, pow2, group),
                           int4_matvec.int4_matvec_ref(onehot, packed, pow2,
                                                       group))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_the_card(dtype):
    """K1 and K3 against their twins, every element within the kernel's
    limit (``ms_deform_attn_limit``, ``window_attention_limit``: one bf16
    step of the output in bf16, 1e-5 in f32, and the roundings of the
    magnitude); K3 at N = 16 (head dim 16) and at N = 49 (a 7x7 window,
    head dim 32: the ragged edge of the bf16 kernel's 16-row tiles)."""
    _require_card()
    for radius in (None, 1.5):
        args = _deform_args("cuda", dtype)
        got = msdeform.ms_deform_attn(*args, radius=radius)
        want = msdeform.ms_deform_attn_ref(*args, radius=radius)
        mag = msdeform.ms_deform_attn_magnitude(*args, radius=radius)
        limit = msdeform.ms_deform_attn_limit(want, mag, dtype)
        assert ((got.float() - want.float()).abs() <= limit).all(), radius
    for N, C, h in ((16, 32, 2), (49, 128, 4)):
        for masked in (False, True):
            qkv, bias, mask, _, _ = _swin_args("cuda", dtype, N=N, C=C, h=h)
            args = (qkv, bias, mask if masked else None, h, (C // h) ** -0.5)
            got = swin_attention.window_attention(*args)
            want = swin_attention.window_attention_ref(*args)
            mag = swin_attention.window_attention_magnitude(*args)
            limit = swin_attention.window_attention_limit(want, mag, dtype)
            assert ((got.float() - want.float()).abs() <= limit).all(), \
                (N, masked)


def _flash_limit(dtype, want, magnitude, atol):
    """Per element: 1e-5 |want| + atol in f32; in bf16 ``bf16_limit`` (one
    bf16 step of the output, and 2^-8 of the magnitude of the product whose
    operand the kernel rounds to bf16, as the stock kernel does)."""
    if dtype == torch.bfloat16:
        return flash_attention.bf16_limit(want, magnitude, atol)
    return 1e-5 * want.float().abs() + atol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version_on_the_card(dtype):
    """K5 against flash_attention_ref, causal and not, at each head dim, at
    lengths that are no multiple of the kernel's tiles, each element within
    ``_flash_limit`` (atol 1e-5): the f32 kernel and the plain version
    differ in the order of f32 sums; the bf16 kernel also rounds P before
    P v."""
    _require_card()
    n = flash_attention.LAUNCHES
    for hd in flash_attention.HEAD_DIMS:
        for L, causal in ((37, True), (200, False), (577, True)):
            q, k, v = _flash_args("cuda", dtype, B=2, h=3, L=L, hd=hd)
            kw = dict(causal=causal, sm_scale=hd ** -0.5)
            got = flash_attention.flash_attention(q, k, v, **kw).float()
            want = flash_attention.flash_attention_ref(q, k, v, **kw).float()
            mag = flash_attention.flash_attention_magnitude(q, k, v, **kw)
            limit = _flash_limit(dtype, want, mag, 1e-5)
            assert ((got - want).abs() <= limit).all(), (hd, L, causal)
    assert flash_attention.LAUNCHES == n + 3 * len(flash_attention.HEAD_DIMS)


def test_backward_wrappers_dispatch_like_the_forwards(monkeypatch):
    """K2 and the K5 backward: the plain twins for CPU tensors (no launch
    counted), the kernel loader for any other device."""
    counts = (msdeform.BWD_LAUNCHES, flash_attention.BWD_LAUNCHES)
    value, shapes, starts, loc, attn = _deform_args()
    g = torch.randn(1, loc.shape[1], value.shape[2] * value.shape[3])
    got = msdeform.ms_deform_attn_bwd(value, shapes, starts, loc, attn, g)
    want = msdeform.ms_deform_attn_bwd_ref(value, shapes, starts, loc, attn, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    q, k, v = _flash_args()
    out, lse = flash_attention._ref_forward(q, k, v, True, 0.3, with_lse=True)
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, out,
                                              causal=True, sm_scale=0.3)
    want = flash_attention.flash_attention_bwd_ref(q, k, v, out, lse, out,
                                                   causal=True, sm_scale=0.3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (msdeform.BWD_LAUNCHES, flash_attention.BWD_LAUNCHES) == counts

    def loader():
        raise RuntimeError("kernel loader reached")

    monkeypatch.setattr(_build, "library", loader)
    meta = _deform_args("meta")
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        msdeform.ms_deform_attn_bwd(*meta, g.to("meta"))
    mq, mk, mv = _flash_args("meta")
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        flash_attention.flash_attention_bwd(mq, mk, mv, mq, lse.to("meta"), mq,
                                            causal=False, sm_scale=1.0)


def test_forwards_keep_what_their_backward_needs_only_under_grad():
    """With a gradient to compute, flash_attention saves the log-sum-exp
    and its backward runs (the plain versions here); without, the call is
    the plain forward and builds no graph."""
    q, k, v = (t.requires_grad_() for t in _flash_args())
    out = flash_attention.flash_attention(q, k, v, causal=False, sm_scale=0.3)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    with torch.no_grad():
        out = flash_attention.flash_attention(q, k, v, causal=False,
                                              sm_scale=0.3)
    assert out.grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_its_plain_twin_on_the_card(dtype):
    """K2 against autograd through ms_deform_attn_ref on the same inputs
    upcast to f32, exact and clamped: every element of d value, d loc and
    d attn within ``ms_deform_attn_bwd_limit`` (rtol |want| + c M, M the
    sum of its terms' absolute values and c from their number; rtol 2^-7
    for the bf16 outputs d value and d attn, which are rounded once, 1e-5
    otherwise)."""
    _require_card()
    n = msdeform.BWD_LAUNCHES
    for radius in (None, 1.5):
        value, shapes, starts, loc, attn = _deform_args("cuda", dtype)
        g = torch.randn(1, loc.shape[1], value.shape[2] * value.shape[3],
                        device="cuda").to(dtype)
        got = msdeform.ms_deform_attn_bwd(value, shapes, starts, loc, attn, g,
                                          radius=radius)
        args = (value.float(), shapes, starts, loc, attn.float(), g.float())
        want = msdeform.ms_deform_attn_bwd_ref(*args, radius=radius)
        mag = msdeform.ms_deform_attn_bwd_magnitude(*args, radius=radius)
        limits = msdeform.ms_deform_attn_bwd_limit(want, mag, dtype)
        for name, a, b, lim in zip(("value", "loc", "attn"), got, want,
                                   limits):
            assert a.dtype == (torch.float32 if name == "loc" else dtype)
            assert ((a.float() - b).abs() <= lim).all(), (radius, name)
    assert msdeform.BWD_LAUNCHES == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,L,P", [(32, 3, 4), (24, 3, 4), (6, 3, 4),
                                   (6, 2, 3)])
def test_sampler_kernels_take_every_layout_on_the_card(dtype, D, L, P):
    """K1 and K2 in each of their thread layouts against their twins, exact
    and clamped, within ``ms_deform_attn_limit`` and
    ``ms_deform_attn_bwd_limit``: the model's L = 3, P = 4 and run-time L,
    P; 16-byte channel vectors with a head's threads all busy (D = 32),
    with idle threads (D = 24: 3 vectors in bf16, 6 in f32, on 4 and 8
    threads), and single channels (D = 6, 12 or 24 bytes)."""
    _require_card()
    shapes = ((5, 7), (3, 4), (2, 2))[:L]
    S, M = sum(h * w for h, w in shapes), 3
    g = torch.Generator().manual_seed(D + L)
    value = torch.randn(2, S, M, D, generator=g).to("cuda", dtype)
    loc = (torch.rand(2, S, M, L, P, 2, generator=g) * 1.4 - 0.2).cuda()
    attn = torch.rand(2, S, M, L, P, generator=g).to("cuda", dtype)
    grad = torch.randn(2, S, M * D, generator=g).to("cuda", dtype)
    starts = msdeform.level_starts(shapes)
    for radius in (None, 1.5):
        args = (value, shapes, starts, loc, attn)
        got = msdeform.ms_deform_attn(*args, radius=radius)
        plain = (value.float(), shapes, starts, loc, attn.float())
        want = msdeform.ms_deform_attn_ref(*plain, radius=radius)
        mag = msdeform.ms_deform_attn_magnitude(*plain, radius=radius)
        limit = msdeform.ms_deform_attn_limit(want, mag, dtype)
        assert ((got.float() - want).abs() <= limit).all(), radius
        got = msdeform.ms_deform_attn_bwd(*args, grad, radius=radius)
        want = msdeform.ms_deform_attn_bwd_ref(*plain, grad.float(),
                                               radius=radius)
        mag = msdeform.ms_deform_attn_bwd_magnitude(*plain, grad.float(),
                                                    radius=radius)
        limits = msdeform.ms_deform_attn_bwd_limit(want, mag, dtype)
        for name, a, b, lim in zip(("value", "loc", "attn"), got, want,
                                   limits):
            assert ((a.float() - b).abs() <= lim).all(), (radius, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain_version_on_the_card(dtype):
    """The K5 backward against flash_attention_bwd_ref on the same inputs
    (out and lse from the kernel's forward), causal and not, each head dim,
    ragged lengths: each element within ``_flash_limit`` with atol 1e-5 of
    the largest |want| (in bf16 the kernel rounds P before dv's product and
    dS before dk's and dq's)."""
    _require_card()
    n = flash_attention.BWD_LAUNCHES
    for hd in flash_attention.HEAD_DIMS:
        for L, causal in ((37, True), (200, False), (577, True)):
            q, k, v = _flash_args("cuda", dtype, B=2, h=3, L=L, hd=hd)
            do = torch.randn_like(q)
            out, lse = flash_attention._forward(q, k, v, causal, hd ** -0.5,
                                                with_lse=True)
            _, want_lse = flash_attention._ref_forward(
                q, k, v, causal, hd ** -0.5, with_lse=True)
            assert (lse - want_lse).abs().max().item() <= 1e-4
            kw = dict(causal=causal, sm_scale=hd ** -0.5)
            args = (q, k, v, out, lse, do)
            got = flash_attention.flash_attention_bwd(*args, **kw)
            want = flash_attention.flash_attention_bwd_ref(*args, **kw)
            mags = flash_attention.flash_attention_bwd_magnitude(*args, **kw)
            for a, b, mag in zip(got, want, mags):
                b = b.float()
                limit = _flash_limit(dtype, b, mag, 1e-5 * b.abs().max())
                assert ((a.float() - b).abs() <= limit).all(), (hd, L, causal)
    assert flash_attention.BWD_LAUNCHES == n + 3 * len(flash_attention.HEAD_DIMS)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "float16"), (dict(B=17), "17 rows"),
    (dict(B=0), "0 rows"), (dict(transposed=True), "contiguous"),
    ({}, "meta")])
def test_int4_wrapper_refuses_a_bad_x_before_launch(monkeypatch, bad, match):
    """x is checked on every call, before any launch: its type, width, row
    count, layout and device."""
    monkeypatch.setattr(_build, "library", lambda: None)
    n = int4_matvec.LAUNCHES
    transposed = bad.pop("transposed", False)
    x, packed, scale, group = _int4_args("meta", **bad)
    if transposed:
        x = torch.empty(x.shape[1], x.shape[0], device="meta").t()
    with pytest.raises((ValueError, TypeError), match=match):
        int4_matvec.int4_matvec(x, packed, scale, group)
    assert int4_matvec.LAUNCHES == n


def _bad_weights():
    _, packed, scale, group = _int4_args("meta")
    shifted = torch.empty(packed.numel() + 1, dtype=torch.int8,
                          device="meta")[1:].view(packed.shape)
    return [(packed.to(torch.int16), scale, "packed must be int8"),
            (packed[:64], scale, "packed must be int8"),
            (packed, scale.double(), "scale must be float32"),
            (packed, scale[:, :64], "scale must be float32"),
            (packed.t().contiguous().t(), scale, "contiguous"),
            (shifted, scale, "16-byte boundary"),
            (packed, scale, "packed on meta")]


@pytest.mark.parametrize("case", range(7))
def test_int4_weight_is_refused_before_launch(monkeypatch, case):
    """A bad weight raises before any launch, from ``check_weight`` and
    from a ``Quant4Dense`` of storage "pallas" (which checks its buffers
    once per weight)."""
    from psalm_tpu_torch.models.quant import Quant4Dense
    monkeypatch.setattr(_build, "library", lambda: None)
    packed, scale, match = _bad_weights()[case]
    with pytest.raises(ValueError, match=match):
        int4_matvec.check_weight(packed, scale, 256, 64)
    layer = Quant4Dense(256, 128, storage="pallas", device="meta")
    layer.packed, layer.scale = packed, scale
    n = int4_matvec.LAUNCHES
    with pytest.raises(ValueError, match=match):
        layer(torch.empty(1, 256, device="meta"))
    assert int4_matvec.LAUNCHES == n


def test_quant4_checks_its_weight_once_per_buffer(monkeypatch):
    """The decode step pays K4's weight check and gate once per weight and
    row count: again only when a buffer is replaced."""
    from psalm_tpu_torch.models import quant
    checks, gates, calls = [], [], []
    monkeypatch.setattr(quant, "check_weight",
                        lambda *a: checks.append(a[2:]))
    monkeypatch.setattr(quant, "int4_matvec_supported",
                        lambda *a: gates.append(a) or True)

    def fake(x, packed, scale, group, *, weight_checked):
        calls.append(weight_checked)
        return torch.zeros(x.shape[0], packed.shape[1], device=x.device)

    monkeypatch.setattr(quant, "int4_matvec", fake)
    layer = quant.Quant4Dense(256, 128, storage="pallas", device="meta")
    x = torch.empty(2, 1, 256, device="meta")
    for _ in range(3):
        assert layer(x).shape == (2, 1, 128)
    assert checks == [(256, 64)] and len(gates) == 1
    layer.packed = layer.packed.clone()
    layer(x)
    layer(torch.empty(3, 256, device="meta"))
    assert len(checks) == 2 and len(gates) == 2
    assert calls == [True] * 5
    cpu = quant.Quant4Dense(256, 128, storage="pallas")
    cpu(torch.zeros(1, 256))  # the plain version: no weight check
    assert len(checks) == 2 and calls[-1] is False


@pytest.mark.gpu
def test_tiny_clis_on_the_card_match_the_cpu():
    """The tiny panoptic and instance CLIs with the kernels on the card
    against the same CLIs with the plain versions on the CPU (chip_smoke.py
    phase 12's check): the CPU's panoptic PNGs hold segments and the card's
    agree with them on 99% of pixels, the semantic metrics to 1e-6, ranked
    instance records item by item where their scores are 1e-3 apart. TF32
    off, as chip_smoke.py runs it: with the defaults (cuDNN's convolutions
    in TF32) the instance scores moved past that limit on the H100."""
    _require_card()
    import chip_smoke
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        chip_smoke.check_small_clis(torch, np)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
