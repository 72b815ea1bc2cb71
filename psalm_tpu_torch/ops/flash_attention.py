"""Softmax attention without the [L, L] logits: kernel K5, its backward, and
their plain twins.

Counterpart of the stock TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` as ``psalm_tpu`` calls
it: causal in Phi's ``use_flash`` branch (``psalm_tpu/models/phi.py``,
``PhiAttention``) and non-causal in the pixel decoder's dense mode
(``psalm_tpu/models/pixel_decoder.py``, ``DenseSelfAttention``). Neither call
passes a bias or segment ids, so there is no padding mask: right padding
keeps every valid causal row exact, and pad rows are never read.

  q, k, v  [B, h, L, hd]  f32 or bf16, one type
  -> out   [B, h, L, hd]  the input's type

out = softmax(q k^T * sm_scale, with keys after the query masked when
``causal``) v, logits, softmax and accumulator in f32. The JAX branch padded
L to a multiple of 128 for the TPU's tiles; the kernel takes any L.

On the card the input's type picks the kernel, a fixed dispatch: bf16 runs
on the tensor cores and rounds P (and in the backward dS) to bf16 before
its product, as the stock kernel does, so it agrees with the f32 plain
version within ``bf16_limit``; f32 runs on the CUDA cores, exact to f32.

``flash_attention`` is differentiable: when a gradient is needed, the
forward also keeps each row's log-sum-exp (f32 [B, h, L]), and the backward
(``flash_attention_bwd``: kernel ``csrc/flash_attention_bwd.cu`` on the card,
``flash_attention_bwd_ref`` on the CPU) recomputes the probabilities from
it, the counterpart of the stock kernel's Pallas backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from psalm_tpu_torch.ops import _build

#: Launches of the CUDA kernels since the last reset: the forward, all of
#: them and the causal ones, and the backward likewise (the plain versions
#: and the CPU path do not count).
LAUNCHES = 0
CAUSAL_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_CAUSAL_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128)  # the kernels' instantiations in csrc
MAX_HEADS = 65535          # B * h is the grid's y dimension

# the plain versions' logits chunk: [B, h, rows, L] f32 of at most 512 MB
_REF_CHUNK_BYTES = 1 << 29


def _ref_rows(B: int, h: int, L: int) -> int:
    return max(1, _REF_CHUNK_BYTES // (4 * B * h * max(L, 1)))


def _ref_logits(q, kf, r0: int, r1: int, causal: bool, sm_scale: float):
    """f32 logits of query rows [r0, r1), -inf above the causal diagonal."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                          kf) * sm_scale
    if causal:
        keys = torch.arange(kf.shape[2], device=q.device)
        later = keys[None, :] > torch.arange(r0, r1, device=q.device)[:, None]
        logits = logits.masked_fill(later, float("-inf"))
    return logits


def _ref_forward(q, k, v, causal: bool, sm_scale: float, with_lse: bool,
                 magnitude: bool = False):
    """Plain PyTorch forward: f32 einsum, softmax, einsum, over chunks of
    query rows, so that at S = 21504 it holds about 1 GB of logits and
    probabilities at a time. Returns (out, lse or None). With ``magnitude``,
    out is P |v| in f32 (``flash_attention_magnitude``)."""
    B, h, L, hd = q.shape
    kf, vf = k.float(), v.float()
    if magnitude:
        vf = vf.abs()
    out = torch.empty(B, h, L, hd, device=q.device,
                      dtype=torch.float32 if magnitude else q.dtype)
    lse = (torch.empty(B, h, L, dtype=torch.float32, device=q.device)
           if with_lse else None)
    rows = _ref_rows(B, h, L)
    for r0 in range(0, L, rows):
        r1 = min(L, r0 + rows)
        logits = _ref_logits(q, kf, r0, r1, causal, sm_scale)
        probs = torch.softmax(logits, dim=-1)
        out[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", probs,
                                        vf).to(out.dtype)
        if with_lse:
            lse[:, :, r0:r1] = torch.logsumexp(logits, dim=-1)
    return out, lse


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the forward (``_ref_forward``)."""
    return _ref_forward(q, k, v, causal, sm_scale, with_lse=False)[0]


def _ref_backward(q, k, v, out, lse, dout, causal: bool, sm_scale: float,
                  magnitude: bool):
    """The plain backward's loop (``flash_attention_bwd_ref``); with
    ``magnitude`` each product takes the absolute values of its operands
    and the f32 result is returned (``flash_attention_bwd_magnitude``)."""
    B, h, L, hd = q.shape
    size = torch.abs if magnitude else (lambda t: t)
    kf, vf = k.float(), v.float()
    delta = (dout.float() * out.float()).sum(-1)
    dq = torch.empty(B, h, L, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, h, L, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros(B, h, L, hd, dtype=torch.float32, device=q.device)
    rows = _ref_rows(B, h, L)
    for r0 in range(0, L, rows):
        r1 = min(L, r0 + rows)
        qc, doc = q[:, :, r0:r1].float(), dout[:, :, r0:r1].float()
        p = torch.exp(_ref_logits(q, kf, r0, r1, causal, sm_scale)
                      - lse[:, :, r0:r1, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p, size(doc))
        ds = size(p * (torch.einsum("bhqd,bhkd->bhqk", doc, vf)
                       - delta[:, :, r0:r1, None]))
        dq[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", ds,
                                       size(kf)) * sm_scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, size(qc)) * sm_scale
    if magnitude:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool,
                            sm_scale: float):
    """Plain PyTorch backward: (dq, dk, dv) in the inputs' type. Written out,
    not autograd through the forward (which would keep 3.7-14.8 GB of
    probabilities at S = 21504): per chunk of query rows the probabilities
    are recomputed from the log-sum-exp, P = exp(logits - lse), and with
    D = rowsum(dout * out), dS = P (dout v^T - D):
    dv += P^T dout, dq = dS k * sm_scale, dk += dS^T q * sm_scale; all f32."""
    return _ref_backward(q, k, v, out, lse, dout, causal, sm_scale,
                         magnitude=False)


# The bf16 kernels round one operand of a product to bf16 where the stock
# TPU kernel does: P before P v (forward) and P^T dO (dV), dS before dS^T q
# (dK) and dS k (dQ). Rounding to bf16 moves a value by at most 2^-8 of its
# size, so it moves each output element by at most 2^-8 times the product
# of the operands' absolute values: the magnitudes below.
BF16_ROUNDOFF = 2.0 ** -8


def flash_attention_magnitude(q, k, v, *, causal: bool, sm_scale: float
                              ) -> torch.Tensor:
    """P |v| in f32 [B, h, L, hd], from the plain forward's probabilities:
    per output element, the size of the product whose P the bf16 kernel
    rounds."""
    return _ref_forward(q, k, v, causal, sm_scale, with_lse=False,
                        magnitude=True)[0]


def flash_attention_bwd_magnitude(q, k, v, out, lse, dout, *, causal: bool,
                                  sm_scale: float):
    """(|dS| |k| sm_scale, |dS|^T |q| sm_scale, P^T |dout|) in f32, from the
    plain backward's P and dS: per element of (dq, dk, dv), the size of the
    product whose dS or P the bf16 kernel rounds."""
    return _ref_backward(q, k, v, out, lse, dout, causal, sm_scale,
                         magnitude=True)


def bf16_limit(want: torch.Tensor, magnitude: torch.Tensor, atol
               ) -> torch.Tensor:
    """Per element, the most a bf16 kernel output may differ from the plain
    version's ``want``: one bf16 step of the output (2^-7 |want|: both round
    an f32 value once), the operand rounding (BF16_ROUNDOFF times the
    ``magnitude``), and ``atol``."""
    return (2.0 ** -7 * want.float().abs() + BF16_ROUNDOFF * magnitude.float()
            + atol)


def _check_inputs(q, k, v, *more) -> None:
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention kernel: dtype {q.dtype} "
                        f"(takes {list(_build.DTYPE_CODES)})")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, h, L, hd], got {tuple(q.shape)}")
    B, h, L, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if B * h > MAX_HEADS:
        raise ValueError(f"B * h = {B * h} exceeds {MAX_HEADS}")
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if tuple(t.shape) != (B, h, L, hd) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {(B, h, L, hd)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            # the tensor-core kernels copy 16-byte pieces of each row
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: q is on {q.device}")


def _forward(q, k, v, causal: bool, sm_scale: float, with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, lse or None): the plain version for a CPU tensor, else the
    kernel (csrc/flash_attention.cu) or an error."""
    global LAUNCHES, CAUSAL_LAUNCHES
    if q.device.type == "cpu":
        if with_lse:
            return _ref_forward(q, k, v, causal, sm_scale, with_lse=True)
        return flash_attention_ref(q, k, v, causal=causal,
                                   sm_scale=sm_scale), None
    lib = _build.library()
    _check_inputs(q, k, v)
    B, h, L, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B, h, L, dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = lib.psalm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, _build.DTYPE_CODES[q.dtype],
            B * h, L, hd, int(bool(causal)), float(sm_scale),
            _build.stream_ptr(q.device))
    _build.check(lib, rc, "psalm_flash_attention_fwd")
    LAUNCHES += 1
    CAUSAL_LAUNCHES += bool(causal)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool,
                        sm_scale: float):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v), given its output
    ``out``, its log-sum-exp ``lse`` [B, h, L] f32 and the output's gradient
    ``dout``. A CPU tensor goes to ``flash_attention_bwd_ref``; a CUDA
    tensor launches the kernels of csrc/flash_attention_bwd.cu or raises."""
    global BWD_LAUNCHES, BWD_CAUSAL_LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                       sm_scale=sm_scale)
    lib = _build.library()
    _check_inputs(q, k, v, ("out", out), ("dout", dout))
    B, h, L, hd = q.shape
    if tuple(lse.shape) != (B, h, L) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(B, h, L)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, h, L, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.psalm_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _build.DTYPE_CODES[q.dtype], B * h,
            L, hd, int(bool(causal)), float(sm_scale),
            _build.stream_ptr(q.device))
    _build.check(lib, rc, "psalm_flash_attention_bwd")
    BWD_LAUNCHES += 1
    BWD_CAUSAL_LAUNCHES += bool(causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward keeps (q, k, v, out, lse); the backward is
    ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _forward(q, k, v, causal, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: float) -> torch.Tensor:
    """Attention over [B, h, L, hd]. A CPU tensor goes to the plain version;
    a CUDA tensor launches the CUDA kernel (csrc/flash_attention.cu) or
    raises. Differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return _forward(q, k, v, causal, sm_scale, with_lse=False)[0]
