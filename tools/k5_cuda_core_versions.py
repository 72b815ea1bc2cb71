#!/usr/bin/env python3
"""Two versions of the CUDA-core K5 forward in bf16, built from the given
source directories and timed in turns on one card, with ptxas's register
counts: how the optional log-sum-exp store of commit d98f7b0 changed the
kernel of commit 7dbe8ed.

    git show 7dbe8ed:psalm_tpu_torch/csrc/flash_attention.cu > A/flash_attention.cu
    git show 7dbe8ed:psalm_tpu_torch/csrc/common.cuh > A/common.cuh
    (the same from d98f7b0 into B)
    python3 tools/k5_cuda_core_versions.py A B

A has 7dbe8ed's C signature (no lse argument), B d98f7b0's (lse, passed
null).
Times: CUDA events over 5 calls, at the dense shapes (S = 21504, 2 heads of
128 and 8 of 32), in the order A, B, B, A, A, B.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(nvcc, flags, src_dir):
    """(library, ptxas lines of the bf16 kernels) of src_dir's source."""
    out = os.path.join(src_dir, "libk5.so")
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-shared", "-o",
                           out, os.path.join(src_dir, "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(proc.stdout + proc.stderr)
    lines = (proc.stdout + proc.stderr).splitlines()
    usage = [f"{lines[i].split(chr(39))[1][:60]}: {lines[i + 3].strip()}"
             for i, line in enumerate(lines)
             if "Compiling entry" in line and "nv_bfloat16" in line]
    return ctypes.CDLL(out), usage


def main():
    import torch
    from psalm_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for tag, src_dir, argtypes in (
            ("A", sys.argv[1], [P, P, P, P, I, I, I, I, I, F, P]),
            ("B", sys.argv[2], [P, P, P, P, P, I, I, I, I, I, F, P])):
        lib, usage = build(nvcc, _build.NVCC_FLAGS, src_dir)
        lib.psalm_flash_attention_fwd.argtypes = argtypes
        libs[tag] = lib
        print(f"== {tag} ({src_dir})\n" + "\n".join(usage))
    st = torch.cuda.current_stream().cuda_stream
    for h, hd in ((2, 128), (8, 32)):
        L = 21504
        q, k, v = (torch.randn(1, h, L, hd, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        o = torch.empty_like(q)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        calls = {"A": lambda: libs["A"].psalm_flash_attention_fwd(
                     *ptrs, 1, h, L, hd, 0, hd ** -0.5, st),
                 "B": lambda: libs["B"].psalm_flash_attention_fwd(
                     *ptrs, None, 1, h, L, hd, 0, hd ** -0.5, st)}
        times = {}
        for tag in ("A", "B", "B", "A", "A", "B"):
            if calls[tag]() != 0:
                sys.exit(f"{tag}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                calls[tag]()
            end.record()
            end.synchronize()
            times.setdefault(tag, []).append(round(start.elapsed_time(end)
                                                   / 5, 3))
        print(f"h={h} hd={hd} S={L}: ms per call {times} on "
              f"{torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
