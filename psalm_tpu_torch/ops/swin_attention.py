"""Swin window-attention core: kernel K3, its backward and their plain
twins.

Counterpart of ``psalm_tpu/ops/swin_attention_pallas.py``: per window and
head, softmax(q k^T * scale + bias[h] (+ mask)) v, softmax in f32, with q, k
and v taken from packed [Bn, N, 3C] rows and the heads packed back into
[Bn, N, C]. The arguments are those of ``fused_window_attention``:

  qkv   [Bn, N, 3C]  f32 or bf16
  bias  [h, N, N]    f32 relative-position bias
  mask  [nW, N, N]   f32 additive shift mask, broadcast over Bn = B * nW
                     (window w uses mask[w % nW]), or None

Its gradient (``window_attention_bwd``, in d qkv and d bias; the mask is a
constant) is the counterpart of the Pallas op's custom VJP (``_op_bwd`` /
``_op_nomask_bwd``, a recompute through ``_xla_reference``): on the card the
CUDA kernel csrc/swin_attention_bwd.cu, through the autograd Function that
``window_attention`` takes whenever a CUDA input needs a gradient; its plain
twin is autograd through ``window_attention_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from psalm_tpu_torch.ops import _build
from psalm_tpu_torch.ops.flash_attention import bf16_limit

#: Launches of the CUDA kernels since the last reset, forward and backward
#: (the plain versions and the CPU path do not count).
LAUNCHES = 0
BWD_LAUNCHES = 0

# csrc/swin_attention.cu: head dims Swin-B's 32 at every stage and the tiny
# test config's 16; the bf16 tensor-core kernel keeps a row of S for up to
# 192 tokens in registers; the f32 kernel stages k and v in shared memory
HEAD_DIMS = (16, 32)
MAX_TC_TOKENS = 192
MAX_SHARED_BYTES = 227 * 1024
# csrc/swin_attention_bwd.cu: the bf16 backward holds a row of S in
# registers for up to 192 tokens, instantiated for windows padded to these
# sizes
MAX_TC_BWD_TOKENS = 192
TC_BWD_PADDED = (16, 64, 144, 192)


def _probs(qkv, bias, mask, nheads: int, scale: float):
    """(softmax(q k^T * scale + bias[h] (+ mask)) in f32 [Bn, h, N, N], v
    [Bn, N, h, hd]): the twin's probabilities, q * scale in qkv's type."""
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
    return torch.softmax(attn, dim=-1), v


def window_attention_ref(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor], nheads: int,
                         scale: float) -> torch.Tensor:
    """Plain PyTorch version, a transcription of
    ``psalm_tpu/ops/swin_attention_pallas.py::_xla_reference``: P rounded
    to qkv's type before P v."""
    Bn, N, C3 = qkv.shape
    attn, v = _probs(qkv, bias, mask, nheads, scale)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.to(qkv.dtype), v)
    return out.reshape(Bn, N, C3 // 3)


def window_attention_magnitude(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor], nheads: int,
                               scale: float) -> torch.Tensor:
    """P |v| in f32 [Bn, N, C], from the twin's own probabilities: per
    output element, the size of the product whose P is rounded."""
    Bn, N, C3 = qkv.shape
    attn, v = _probs(qkv, bias, mask, nheads, scale)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v.float().abs())
    return out.reshape(Bn, N, C3 // 3)


def window_attention_limit(want: torch.Tensor, magnitude: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """Per element, the most the kernel's output may differ from the twin's
    ``want``. bf16: K5's ``bf16_limit`` with atol 1e-5, since the kernel,
    like the twin and the Pallas kernel, rounds P to bf16 before P v (and
    moving P by at most 2^-8 of its size moves each output element by at
    most 2^-8 P |v|, the ``magnitude``). f32: 1e-5 of the output and of the
    magnitude (f32 sums in another order)."""
    if dtype == torch.bfloat16:
        return bf16_limit(want, magnitude, 1e-5)
    return 1e-5 * want.float().abs() + 1e-5 * magnitude.float()


def _check_inputs(qkv, bias, mask, nheads) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention kernel: qkv is on {qkv.device}")
    if qkv.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"window_attention kernel: qkv dtype {qkv.dtype} "
                        f"(takes {list(_build.DTYPE_CODES)})")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [Bn, N, 3C], got {tuple(qkv.shape)}")
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    if C % nheads or C // nheads not in HEAD_DIMS:
        raise ValueError(f"head dim {C}/{nheads} not in {HEAD_DIMS}")
    if qkv.dtype == torch.bfloat16:
        if N > MAX_TC_TOKENS:
            raise ValueError(f"window of N={N} tokens: the bf16 kernel takes "
                             f"at most {MAX_TC_TOKENS}")
        if qkv.data_ptr() % 16:
            # the bf16 kernel copies 16-byte pieces of each head's row
            raise ValueError("qkv must start on a 16-byte boundary")
    elif 2 * N * (C // nheads) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"window of N={N} tokens exceeds shared memory")
    if tuple(bias.shape) != (nheads, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 {(nheads, N, N)}, got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    tensors = [("qkv", qkv), ("bias", bias)]
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N) \
                or mask.dtype != torch.float32 or Bn % mask.shape[0]:
            raise ValueError(f"mask must be float32 [nW, {N}, {N}] with nW "
                             f"dividing Bn={Bn}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        tensors.append(("mask", mask))
    for name, t in tensors:
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_fwd(qkv, bias, mask, nheads: int, scale: float) -> torch.Tensor:
    """K3's forward on checked CUDA inputs."""
    global LAUNCHES
    lib = _build.library()
    Bn, N, C3 = qkv.shape
    out = torch.empty(Bn, N, C3 // 3, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = lib.psalm_window_attention_fwd(
            qkv.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            _build.DTYPE_CODES[qkv.dtype], Bn, N, C3 // 3, nheads,
            mask.shape[0] if mask is not None else 1, float(scale),
            _build.stream_ptr(qkv.device))
    _build.check(lib, rc, "psalm_window_attention_fwd")
    LAUNCHES += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """K3 forward, K3 backward (``window_attention_bwd``); the forward keeps
    its inputs and the backward recomputes P from them, as JAX's VJP does.
    No gradient for the mask, the head count or the scale."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, nheads, scale):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.nheads, ctx.scale = nheads, scale
        return _launch_fwd(qkv, bias, mask, nheads, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, mask, ctx.nheads,
                                           ctx.scale, dout.contiguous())
        return dqkv, dbias, None, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], nheads: int,
                     scale: float) -> torch.Tensor:
    """Window-attention core. A CPU tensor goes to the plain version; a CUDA
    tensor launches the CUDA kernel (csrc/swin_attention.cu) or raises: bf16
    on the tensor cores (within ``window_attention_limit`` of the twin: it
    rounds q * scale and P where the twin does, and sums in f32 in another
    order), f32 on the CUDA cores. Differentiable in qkv and bias: on the
    card its backward is kernel csrc/swin_attention_bwd.cu."""
    if qkv.device.type == "cpu":
        return window_attention_ref(qkv, bias, mask, nheads, scale)
    _build.library()
    _check_inputs(qkv, bias, mask, nheads)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttention.apply(qkv, bias, mask, nheads, scale)
    return _launch_fwd(qkv, bias, mask, nheads, scale)


def window_attention_bwd_ref(qkv: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor], nheads: int,
                             scale: float, dout: torch.Tensor):
    """The plain twin of K3's backward: (d qkv, d bias) by autograd through
    ``window_attention_ref``, as JAX's ``_op_bwd`` takes ``jax.vjp`` of
    ``_xla_reference``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (qkv, bias)]
        out = window_attention_ref(leaves[0], leaves[1], mask, nheads, scale)
        return torch.autograd.grad(out, leaves, dout)


def window_attention_bwd_magnitude(qkv: torch.Tensor, bias: torch.Tensor,
                                   mask: Optional[torch.Tensor], nheads: int,
                                   scale: float, dout: torch.Tensor):
    """(M d qkv [Bn, N, 3C], M d bias [h, N, N]) in f32, from the twin's P
    and dP = dO v^T: per element, the size of the products whose rounded
    operand the kernel may round the other way. dS's is M dS = P (|dP| +
    rowsum(P |dP|)), which bounds how far dS moves when every dP moves by
    its own rounding; then scale M dS |k| for dq, M dS^T |q scale| for dk,
    P^T |dO| for dv (P rounded before P^T dO) and the sum of M dS over the
    windows for d bias."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // nheads
    p, v = _probs(qkv, bias, mask, nheads, scale)
    q = qkv[:, :, :C].reshape(Bn, N, nheads, hd)
    k = qkv[:, :, C:2 * C].reshape(Bn, N, nheads, hd)
    do = dout.reshape(Bn, N, nheads, hd).float()
    dp = torch.einsum("bnhd,bmhd->bhnm", do, v.float()).abs()
    mds = p * (dp + (p * dp).sum(-1, keepdim=True))
    mq = torch.einsum("bhnm,bmhd->bnhd", mds, k.float().abs()) * scale
    mk = torch.einsum("bhnm,bnhd->bmhd", mds, (q * scale).float().abs())
    mv = torch.einsum("bhnm,bnhd->bmhd", p, do.abs())
    mqkv = torch.cat([m.reshape(Bn, N, C) for m in (mq, mk, mv)], dim=-1)
    return mqkv, mds.sum(0)


def window_attention_bwd_limit(want: torch.Tensor, magnitude: torch.Tensor,
                               dtype: torch.dtype) -> torch.Tensor:
    """Per element of d qkv or d bias, the most the kernel's may differ from
    the twin's ``want``, for inputs of ``dtype``. bf16: one bf16 step of
    the output (2^-7 |want|; d qkv is rounded once, as the twin's is), 2^-8
    of the ``magnitude`` (``window_attention_bwd_magnitude``: the bf16
    rounding of dP = dO v^T and of P may fall the other way when the f32
    sums before it run in another order, and the kernel rounds dS to bf16
    as the operand of dq and dK, which moves it by at most 2^-9 M dS) and
    1e-5. f32: 1e-5 of the output and of the magnitude (f32 sums in another
    order; d bias over the windows in the atomics' order)."""
    return window_attention_limit(want, magnitude, dtype)


def _check_bwd_inputs(qkv, bias, mask, nheads, dout) -> None:
    _check_inputs(qkv, bias, mask, nheads)
    Bn, N, C3 = qkv.shape
    if tuple(dout.shape) != (Bn, N, C3 // 3) or dout.dtype != qkv.dtype \
            or dout.device != qkv.device or not dout.is_contiguous():
        raise ValueError(f"dout must be contiguous {qkv.dtype} "
                         f"{(Bn, N, C3 // 3)} on {qkv.device}, got "
                         f"{dout.dtype} {tuple(dout.shape)} on {dout.device}")
    if qkv.dtype == torch.bfloat16:
        if N > MAX_TC_BWD_TOKENS:
            raise ValueError(f"window of N={N} tokens: the bf16 backward "
                             f"takes at most {MAX_TC_BWD_TOKENS}")
        if dout.data_ptr() % 16:
            raise ValueError("dout must start on a 16-byte boundary")
    if bwd_shared_bytes(N, C3 // 3 // nheads, qkv.dtype) > MAX_SHARED_BYTES:
        raise ValueError(f"window of N={N} tokens exceeds the backward's "
                         "shared memory")


def bwd_shared_bytes(N: int, hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of K3's backward kernel for windows of N
    tokens. bf16, N padded to the instantiation's size NP: two buffers of
    q, k, v and dO as bf16 rows of hd + 8, the P / dS tile (bf16 rows of
    NP + 8) and, where it fits, the d bias sum (f32 rows of NP + 8); f32:
    q scale, k, v and dO as f32 and three row vectors."""
    if dtype != torch.bfloat16:
        return (4 * N * hd + 3 * N) * 4
    NP = next((p for p in TC_BWD_PADDED if N <= p), N)
    used = 2 * (2 * 4 * NP * (hd + 8)) + 2 * NP * (NP + 8)
    sums = 4 * NP * (NP + 8)
    return used + sums if used + sums <= MAX_SHARED_BYTES else used


@functools.lru_cache(maxsize=None)
def bwd_groups(device_index: int, Bn: int, N: int, C: int,
               nheads: int) -> int:
    """Window groups per head of the bf16 backward (each block sums d bias
    over one group; the groups' partials are summed in order), as
    csrc/swin_attention_bwd.cu plans them for the device's SMs, cached per
    shape."""
    lib = _build.library()
    groups = ctypes.c_int(1)
    with torch.cuda.device(device_index):
        rc = lib.psalm_window_attention_bwd_groups(Bn, N, C, nheads,
                                                   ctypes.byref(groups))
    _build.check(lib, rc, "psalm_window_attention_bwd_groups")
    return groups.value


def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor], nheads: int,
                         scale: float, dout: torch.Tensor):
    """(d qkv [Bn, N, 3C] in qkv's type, d bias [h, N, N] f32) of
    ``window_attention`` for the output gradient ``dout`` [Bn, N, C]: the
    plain twin for a CPU tensor, else the CUDA kernel
    (csrc/swin_attention_bwd.cu) or an error: bf16 on the tensor cores,
    with d bias summed over each group of windows and then over the groups
    in a fixed order (the same bits on every call), f32 on the CUDA
    cores."""
    global BWD_LAUNCHES
    if qkv.device.type == "cpu":
        return window_attention_bwd_ref(qkv, bias, mask, nheads, scale, dout)
    lib = _build.library()
    _check_bwd_inputs(qkv, bias, mask, nheads, dout)
    Bn, N, C3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    if qkv.dtype == torch.bfloat16:
        # each block's d bias over its group of windows, summed in order
        # into every element of dbias
        groups = bwd_groups(qkv.device.index, Bn, N, C3 // 3, nheads)
        partial = torch.empty(nheads, groups, N, N, dtype=torch.float32,
                              device=qkv.device)
        dbias = torch.empty_like(bias)
    else:
        groups, partial = 1, None
        dbias = torch.zeros_like(bias)  # the kernel adds every window into it
    with torch.cuda.device(qkv.device):
        rc = lib.psalm_window_attention_bwd(
            qkv.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, dout.data_ptr(),
            dqkv.data_ptr(), dbias.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            _build.DTYPE_CODES[qkv.dtype], Bn, N, C3 // 3, nheads,
            mask.shape[0] if mask is not None else 1, groups, float(scale),
            _build.stream_ptr(qkv.device))
    _build.check(lib, rc, "psalm_window_attention_bwd")
    BWD_LAUNCHES += 1
    return dqkv, dbias
