"""Build and load the hand-written CUDA kernels of ``psalm_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into one shared
library with a plain C interface, which is loaded with ``ctypes``. The
library is built at first use into ``build/psalm_tpu_torch/`` at the root of
the checkout, named by a hash of the sources, so an edited source is rebuilt
and an unchanged one is loaded as it is.

Conventions shared by every launcher in ``csrc``:
  * each ``extern "C"`` launcher returns ``cudaGetLastError()`` as an int;
    ``check`` raises when it is nonzero;
  * every pointer and the stream are passed as ``ctypes.c_void_p``;
  * kernels run on ``torch.cuda.current_stream()`` and allocate nothing: the
    Python wrapper allocates outputs with ``torch.empty``.

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "psalm_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Must match csrc/common.cuh::DType.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every launcher in csrc, in the order of its C signature
SIGNATURES = {
    # value, loc, attn, ref, out, dtype, B, S, Q, M, D, L, P, shapes,
    # radius, clamp, stream
    "psalm_msdeform_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _F, _I, _P],
    # qkv, bias, mask, out, dtype, Bn, N, C, nheads, nW, scale, stream
    "psalm_window_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                   _P],
    # x, packed, scale, partial, out, dtype, B, K, N, group, rows_per_split,
    # splits, stream
    "psalm_int4_matvec": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, dtype, BH, L, hd, causal, scale, stream
    "psalm_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source and header, by name and content."""
    h = hashlib.sha256()
    for p in sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the psalm_tpu_torch CUDA kernels cannot be built")
    return found


def nvcc_command(nvcc: str, srcs: List[Path], out: Path,
                 compile_only: bool = False) -> List[str]:
    """The nvcc command line that builds ``out`` from ``srcs``: the shared
    library, or with ``compile_only`` one source's object file."""
    return [nvcc, *NVCC_FLAGS, "-c" if compile_only else "-shared", "-o",
            str(out), *map(str, srcs)]


def _run_together(cmds: List[List[str]]) -> None:
    """Start every command at once, wait for all, raise if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))


def library_path() -> Path:
    return BUILD_DIR / f"libpsalm_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    try:
        _run_together([nvcc_command(nvcc, [src], obj, compile_only=True)
                       for src, obj in zip(sources(), objs)])
        _run_together([nvcc_command(nvcc, objs, tmp)])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for path in (tmp, *objs):
            path.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.psalm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.psalm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib.psalm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
