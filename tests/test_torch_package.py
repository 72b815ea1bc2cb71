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
              "train.train"):
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


def _swin_args(device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(4, 16, 3 * 32, generator=g).to(device, dtype)
    bias = torch.randn(2, 16, 16, generator=g).to(device)
    mask = torch.randn(2, 16, 16, generator=g).to(device)
    return qkv, bias, mask, 2, 0.25


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


@pytest.mark.parametrize("B,K,N", [(1, 2048, 2048), (4, 2048, 8192),
                                   (16, 8192, 2048), (3, 256, 128)])
def test_int4_plan_covers_the_rows_in_whole_groups(B, K, N):
    rows, splits = int4_matvec.plan(B, K, N, 64)
    assert rows % 64 == 0 and splits == -(-(K // 2) // rows)
    assert splits <= 65535
    bt = 1 << (B - 1).bit_length()
    assert 2 * bt * rows * 4 <= int4_matvec.MAX_SHARED_BYTES
    if K == 2048:  # Phi's q/k/v/dense and fc1: enough blocks for 132 SMs
        assert splits * N // int4_matvec.COLUMNS_PER_BLOCK >= 256


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
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_versions_on_the_card(dtype, atol):
    _require_card()
    for radius in (None, 1.5):
        args = _deform_args("cuda", dtype)
        got = msdeform.ms_deform_attn(*args, radius=radius).float()
        want = msdeform.ms_deform_attn_ref(*args, radius=radius).float()
        assert (got - want).abs().max().item() <= atol
    for masked in (False, True):
        qkv, bias, mask, h, scale = _swin_args("cuda", dtype)
        m = mask if masked else None
        got = swin_attention.window_attention(qkv, bias, m, h, scale).float()
        want = swin_attention.window_attention_ref(qkv, bias, m, h, scale).float()
        assert (got - want).abs().max().item() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)])
def test_flash_kernel_matches_plain_version_on_the_card(dtype, rtol):
    """K5 against flash_attention_ref, causal and not, at each head dim, at
    lengths that are no multiple of the kernel's tiles. Per element within
    rtol |want| + 1e-5: both compute in f32 and round to the input's type,
    so in bf16 they differ by at most one bf16 step (2^-7 of the size)."""
    _require_card()
    n = flash_attention.LAUNCHES
    for hd in flash_attention.HEAD_DIMS:
        for L, causal in ((37, True), (200, False), (577, True)):
            q, k, v = _flash_args("cuda", dtype, B=2, h=3, L=L, hd=hd)
            got = flash_attention.flash_attention(q, k, v, causal=causal,
                                                  sm_scale=hd ** -0.5).float()
            want = flash_attention.flash_attention_ref(
                q, k, v, causal=causal, sm_scale=hd ** -0.5).float()
            limit = rtol * want.abs() + 1e-5
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


def _abs_rel_worst(got, want, rtol, atol_rel):
    """Worst |got - want| / (rtol |want| + atol_rel max |want|)."""
    got, want = got.float(), want.float()
    limit = rtol * want.abs() + atol_rel * want.abs().max() + 1e-30
    return ((got - want).abs() / limit).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_its_plain_twin_on_the_card(dtype):
    """K2 against autograd through ms_deform_attn_ref on the same inputs
    upcast to f32, exact and clamped: each element within rtol |want| +
    1e-5 max |want|, rtol 2^-7 for the bf16 outputs (d value and d attn
    are rounded once to bf16), 1e-5 otherwise (the atomics' f32 order)."""
    _require_card()
    n = msdeform.BWD_LAUNCHES
    for radius in (None, 1.5):
        value, shapes, starts, loc, attn = _deform_args("cuda", dtype)
        g = torch.randn(1, loc.shape[1], value.shape[2] * value.shape[3],
                        device="cuda").to(dtype)
        got = msdeform.ms_deform_attn_bwd(value, shapes, starts, loc, attn, g,
                                          radius=radius)
        want = msdeform.ms_deform_attn_bwd_ref(
            value.float(), shapes, starts, loc, attn.float(), g.float(),
            radius=radius)
        for name, a, b in zip(("value", "loc", "attn"), got, want):
            rtol = 2.0 ** -7 if (dtype == torch.bfloat16
                                 and name != "loc") else 1e-5
            assert a.dtype == (torch.float32 if name == "loc" else dtype)
            assert _abs_rel_worst(a, b, rtol, 1e-5) <= 1.0, (radius, name)
    assert msdeform.BWD_LAUNCHES == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)])
def test_flash_backward_matches_plain_version_on_the_card(dtype, rtol):
    """The K5 backward against flash_attention_bwd_ref on the same inputs
    (out and lse from the kernel's forward), causal and not, each head dim,
    ragged lengths: each element within rtol |want| + 1e-5 max |want|."""
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
            got = flash_attention.flash_attention_bwd(
                q, k, v, out, lse, do, causal=causal, sm_scale=hd ** -0.5)
            want = flash_attention.flash_attention_bwd_ref(
                q, k, v, out, lse, do, causal=causal, sm_scale=hd ** -0.5)
            for a, b in zip(got, want):
                assert _abs_rel_worst(a, b, rtol, 1e-5) <= 1.0, (hd, L, causal)
    assert flash_attention.BWD_LAUNCHES == n + 3 * len(flash_attention.HEAD_DIMS)
