"""int4 matvec for the serving decode step: kernel K4 and its plain version.

Counterpart of ``psalm_tpu/ops/int4_matvec.py``: ``y = x @ dequant(packed,
scale)`` in f32 for at most 16 rows of x, on the half-split packing of
``models/quant.py::quantize_kernel_int4`` (the deployed ``Quant4Dense``
format):

  x       [B, K]     f32 or bf16, B <= 16
  packed  [K/2, N]   int8; byte (i, n) holds q[i, n] in its low nibble and
                     q[K/2 + i, n] in its high nibble, both signed 4-bit
  scale   [K/g, N]   f32 group scales along K; groups never straddle K/2
  -> y    [B, N]     f32

so that y[b, n] = sum_k x[b, k] * q[k, n] * scale[k // g, n].
"""

from __future__ import annotations

import torch

from psalm_tpu_torch.ops import _build

#: Launches of the CUDA kernel since the last reset (the plain version and the
#: CPU path do not count).
LAUNCHES = 0

MAX_ROWS = 16
COLUMNS_PER_BLOCK = 128  # csrc/int4_matvec.cu: 64 threads x 2 columns
TARGET_BLOCKS = 264      # two blocks for each of the H100's 132 SMs
MAX_SHARED_BYTES = 48 * 1024


def int4_matvec_supported(rows: int, K: int, N: int, group: int) -> bool:
    """Shapes the kernel takes; ``Quant4Dense`` sends everything else to its
    packed plain math. The same gate as
    ``psalm_tpu/ops/int4_matvec.py::int4_matvec_supported``."""
    if K % 2:
        return False
    half = K // 2
    if group <= 0 or half % group or N % 128:
        return False
    kch = half if half <= 2048 else 2048
    return half % kch == 0 and kch % group == 0 and rows <= 16


def unpack_int4(packed: torch.Tensor):
    """(low, high) int8 nibbles of the packed bytes, sign-extended: the
    first and the second half of the input axis."""
    low = ((packed & 0xF) ^ 8) - 8
    high = packed >> 4  # arithmetic shift of a signed byte
    return low, high


def int4_matvec_ref(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, group: int) -> torch.Tensor:
    """Plain PyTorch version, a transcription of
    ``psalm_tpu/ops/int4_matvec.py::int4_matvec_xla``: per-group partial
    dots in f32, then the group scales."""
    B, K = x.shape
    half, N = packed.shape
    G = K // group
    low, high = unpack_int4(packed)
    xg = x.float().reshape(B, 2, G // 2, group)
    kl = low.reshape(G // 2, group, N).float()
    kh = high.reshape(G // 2, group, N).float()
    p_lo = torch.einsum("bgd,gdo->bgo", xg[:, 0], kl)
    p_hi = torch.einsum("bgd,gdo->bgo", xg[:, 1], kh)
    part = torch.cat([p_lo, p_hi], dim=1)
    return torch.einsum("bgo,go->bo", part, scale.float())


def plan(B: int, K: int, N: int, group: int):
    """(rows per split, splits): how csrc/int4_matvec.cu cuts the K/2
    packed rows across blocks. Each split is a whole number of groups, so a
    block sees one low and one high scale row per group; enough splits that
    the launch has about ``TARGET_BLOCKS`` blocks; and the block's x rows fit
    in shared memory."""
    half = K // 2
    n_groups = half // group
    col_blocks = -(-N // COLUMNS_PER_BLOCK)
    splits = max(1, min(n_groups, -(-TARGET_BLOCKS // col_blocks)))
    groups_per_split = -(-n_groups // splits)
    bt = 1 << max(0, B - 1).bit_length()  # rows padded to a power of two
    cap = max(1, MAX_SHARED_BYTES // (2 * bt * group * 4))
    groups_per_split = min(groups_per_split, cap)
    rows = groups_per_split * group
    return rows, -(-half // rows)


def _check_inputs(x, packed, scale, group) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"int4_matvec kernel: x is on {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"int4_matvec kernel: x dtype {x.dtype} "
                        f"(takes {list(_build.DTYPE_CODES)})")
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"x must be [B, K] and packed [K/2, N], got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    B, K = x.shape
    half, N = packed.shape
    if packed.dtype != torch.int8 or 2 * half != K:
        raise ValueError(f"packed must be int8 [{K // 2}, N], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if not int4_matvec_supported(B, K, N, group):
        raise ValueError(f"int4_matvec kernel: rows={B}, K={K}, N={N}, "
                         f"group={group} is not a supported shape")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (K // group, N):
        raise ValueError(f"scale must be float32 {(K // group, N)}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel reads 2 packed bytes and 2 scales per thread
    if packed.data_ptr() % 2 or scale.data_ptr() % 8:
        raise ValueError("packed must be 2-byte and scale 8-byte aligned")


def int4_matvec(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                group: int) -> torch.Tensor:
    """x @ dequant(packed, scale) as f32 [B, N]. A CPU tensor goes to the
    plain version; a CUDA tensor launches the CUDA kernel
    (csrc/int4_matvec.cu) or raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return int4_matvec_ref(x, packed, scale, group)
    lib = _build.library()
    _check_inputs(x, packed, scale, group)
    B, K = x.shape
    N = packed.shape[1]
    rows, splits = plan(B, K, N, group)
    out = torch.empty(B, N, dtype=torch.float32, device=x.device)
    partial = (torch.empty(splits, B, N, dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        rc = lib.psalm_int4_matvec(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            out.data_ptr(), _build.DTYPE_CODES[x.dtype], B, K, N, group, rows,
            splits, _build.stream_ptr(x.device))
    _build.check(lib, rc, "psalm_int4_matvec")
    LAUNCHES += 1
    return out
