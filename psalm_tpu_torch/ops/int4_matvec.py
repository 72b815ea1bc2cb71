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

import functools

import torch

from psalm_tpu_torch.ops import _build

#: Launches of the CUDA kernel since the last reset (the plain version and the
#: CPU path do not count).
LAUNCHES = 0

MAX_ROWS = 16
# csrc/int4_matvec.cu: 128 threads a block, 16 columns a thread, pieces of 8
# packed rows (of 1 where 8 does not divide the group), clusters of at most 8
THREADS = 128
COLUMNS_PER_THREAD = 16
PIECE_ROWS = 8
MAX_CLUSTER = 8


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


@functools.lru_cache(maxsize=None)
def plan(B: int, K: int, N: int, group: int):
    """(cluster, column threads, rows per rank): how csrc/int4_matvec.cu
    cuts one call, cached per shape.

    The K/2 packed rows go to the ranks of one thread-block cluster (at most
    8), a whole number of groups each, every rank holding at least one
    group; the last rank takes what is left. In a block of 128 threads,
    ``tc`` threads side by side take 16 columns each and 128 / tc rows of
    threads take pieces of 8 packed rows; ``tc`` is the largest power of two
    (at most 32, dividing N / 16) that still gives every thread at most one
    piece, so that a launch holds its whole matrix in flight at once."""
    half = K // 2
    n_groups = half // group
    per_rank = -(-n_groups // min(MAX_CLUSTER, n_groups))
    cluster = -(-n_groups // per_rank)
    rows = per_rank * group
    pieces = rows // (PIECE_ROWS if group % PIECE_ROWS == 0 else 1)
    tc = 32
    while tc > 1 and (THREADS // tc < pieces
                      or N % (COLUMNS_PER_THREAD * tc)):
        tc //= 2
    return cluster, tc, rows


def check_weight(packed: torch.Tensor, scale: torch.Tensor, K: int,
                 group: int) -> None:
    """Raise unless the kernel takes this weight for inputs of width K: int8
    [K/2, N] and f32 [K/group, N], contiguous, 16-byte aligned, on a CUDA
    device. ``Quant4Dense`` runs this once per weight, not per call."""
    if packed.dim() != 2 or packed.dtype != torch.int8 \
            or 2 * packed.shape[0] != K:
        raise ValueError(f"packed must be int8 [{K // 2}, N], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    N = packed.shape[1]
    if not int4_matvec_supported(1, K, N, group):
        raise ValueError(f"int4_matvec kernel: K={K}, N={N}, group={group} "
                         "is not a supported shape")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (K // group, N):
        raise ValueError(f"scale must be float32 {(K // group, N)}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    for name, t in (("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            # the kernel reads 16 bytes of a packed row or of a scale row
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if packed.device.type != "cuda" or scale.device != packed.device:
        raise ValueError(f"int4_matvec kernel: packed on {packed.device}, "
                         f"scale on {scale.device}")


def _check_x(x: torch.Tensor, packed: torch.Tensor) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"int4_matvec kernel: x dtype {x.dtype} "
                        f"(takes {list(_build.DTYPE_CODES)})")
    if x.dim() != 2 or x.shape[1] != 2 * packed.shape[0]:
        raise ValueError(f"x must be [B, {2 * packed.shape[0]}], got "
                         f"{tuple(x.shape)}")
    if not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"int4_matvec kernel: {x.shape[0]} rows (takes 1 to "
                         f"{MAX_ROWS})")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type != "cuda" or x.device != packed.device:
        raise ValueError(f"int4_matvec kernel: x is on {x.device}, packed on "
                         f"{packed.device}")


def int4_matvec(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                group: int, *, weight_checked: bool = False) -> torch.Tensor:
    """x @ dequant(packed, scale) as f32 [B, N]. A CPU tensor goes to the
    plain version; a CUDA tensor launches the CUDA kernel
    (csrc/int4_matvec.cu), one launch a call, or raises. x is checked every
    call, the weight (``check_weight``) unless the caller has checked it."""
    global LAUNCHES
    if x.device.type == "cpu":
        return int4_matvec_ref(x, packed, scale, group)
    lib = _build.library()
    _check_x(x, packed)
    if not weight_checked:
        check_weight(packed, scale, x.shape[1], group)
    B, K = x.shape
    N = packed.shape[1]
    cluster, tc, rows = plan(B, K, N, group)
    out = torch.empty(B, N, dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[x.dtype], B, K, N, group, cluster, tc, rows)
    stream = _build.stream_ptr(x.device)
    if x.device.index == torch.cuda.current_device():  # no device switch
        rc = lib.psalm_int4_matvec(*args, stream)
    else:
        with torch.cuda.device(x.device):
            rc = lib.psalm_int4_matvec(*args, stream)
    _build.check(lib, rc, "psalm_int4_matvec")
    LAUNCHES += 1
    return out
