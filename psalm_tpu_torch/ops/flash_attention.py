"""Softmax attention without the [L, L] logits: kernel K5 and its plain twin.

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
"""

from __future__ import annotations

import torch

from psalm_tpu_torch.ops import _build

#: Launches of the CUDA kernel since the last reset, all of them and the
#: causal ones (the plain version and the CPU path do not count).
LAUNCHES = 0
CAUSAL_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128)  # csrc/flash_attention.cu::dispatch_head_dim
MAX_HEADS = 65535          # B * h is the grid's y dimension

# the plain version's logits chunk: [B, h, rows, L] f32 of at most 512 MB
_REF_CHUNK_BYTES = 1 << 29


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version: f32 einsum, softmax, einsum, over chunks of
    query rows, so that at S = 21504 it holds about 1 GB of logits and
    probabilities at a time."""
    B, h, L, hd = q.shape
    kf, vf = k.float(), v.float()
    rows = max(1, _REF_CHUNK_BYTES // (4 * B * h * max(L, 1)))
    keys = torch.arange(L, device=q.device)
    out = torch.empty(B, h, L, hd, dtype=q.dtype, device=q.device)
    for r0 in range(0, L, rows):
        r1 = min(L, r0 + rows)
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                              kf) * sm_scale
        if causal:
            later = keys[None, :] > torch.arange(r0, r1, device=q.device)[:, None]
            logits = logits.masked_fill(later, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
    return out


def _check_inputs(q, k, v) -> None:
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != (B, h, L, hd) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {(B, h, L, hd)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: q is on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: float) -> torch.Tensor:
    """Attention over [B, h, L, hd]. A CPU tensor goes to the plain version;
    a CUDA tensor launches the CUDA kernel (csrc/flash_attention.cu) or
    raises."""
    global LAUNCHES, CAUSAL_LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    lib = _build.library()
    _check_inputs(q, k, v)
    B, h, L, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.psalm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[q.dtype], B * h, L, hd, int(bool(causal)),
            float(sm_scale), _build.stream_ptr(q.device))
    _build.check(lib, rc, "psalm_flash_attention_fwd")
    LAUNCHES += 1
    CAUSAL_LAUNCHES += bool(causal)
    return out
