"""Swin window-attention core: kernel K3 and its plain twin.

Counterpart of ``psalm_tpu/ops/swin_attention_pallas.py``: per window and
head, softmax(q k^T * scale + bias[h] (+ mask)) v, softmax in f32, with q, k
and v taken from packed [Bn, N, 3C] rows and the heads packed back into
[Bn, N, C]. The arguments are those of ``fused_window_attention``:

  qkv   [Bn, N, 3C]  f32 or bf16
  bias  [h, N, N]    f32 relative-position bias
  mask  [nW, N, N]   f32 additive shift mask, broadcast over Bn = B * nW
                     (window w uses mask[w % nW]), or None
"""

from __future__ import annotations

from typing import Optional

import torch

from psalm_tpu_torch.ops import _build

#: Launches of the CUDA kernel since the last reset (the plain version and the
#: CPU path do not count).
LAUNCHES = 0

# csrc/swin_attention.cu::dispatch_head_dim: Swin-B's 32 at every stage, and
# the tiny test config's 16
HEAD_DIMS = (16, 32)
MAX_SHARED_BYTES = 227 * 1024


def window_attention_ref(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor], nheads: int,
                         scale: float) -> torch.Tensor:
    """Plain PyTorch version, a transcription of
    ``psalm_tpu/ops/swin_attention_pallas.py::_xla_reference``."""
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
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
    return out.reshape(Bn, N, C)


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
    if 2 * N * (C // nheads) * 4 > MAX_SHARED_BYTES:
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


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], nheads: int,
                     scale: float) -> torch.Tensor:
    """Window-attention core. A CPU tensor goes to the plain version; a CUDA
    tensor launches the CUDA kernel (csrc/swin_attention.cu) or raises."""
    global LAUNCHES
    if qkv.device.type == "cpu":
        return window_attention_ref(qkv, bias, mask, nheads, scale)
    lib = _build.library()
    _check_inputs(qkv, bias, mask, nheads)
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
