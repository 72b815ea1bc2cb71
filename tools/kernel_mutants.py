#!/usr/bin/env python3
"""Mutation check of the kernels: does chip_smoke.py's limit catch a wrong
kernel?

    python3 tools/kernel_mutants.py [name ...]   # from the root of a
                                                 # checkout; one card

For each mutant, the checkout is copied to a
temporary directory outside it, one kernel source is broken there, and
chip_smoke.py's check of that kernel runs on the copy (building the copy's
kernels). Each must fail; the script prints the lines where it did and
exits nonzero if a mutant passed.
  fwd_no_log2e       the bf16 K5 forward with log2 e dropped from the
                     logits' scale: a softmax at the wrong temperature
                     (check_k5);
  bwd_no_delta       the bf16 K5 backward without D = rowsum(dO O) in
                     dS = P (dP - D), in both its kernels (check_k5_bwd);
  k1_swap_fractions  K1 with its bilinear fractions fx and fy swapped in
                     the corner weights (check_k1);
  k2_loc_x_fx        K2 with d loc_x on fx's stencil (gx, fx) in place of
                     fy's (check_k2);
  k2_swap_w01_w10    K2 scattering d value with the (0, 1) and (1, 0)
                     corners' weights swapped (check_k2);
  k3_no_scale        the bf16 tensor-core K3 without q's scale (check_k3);
  k3_no_bias         the bf16 tensor-core K3 without the relative-position
                     bias (check_k3);
  k4_high_scale_low  K4 reading the high half's group scale from the low
                     half's row (check_k4);
  k3_bwd_no_rowsum   K3's backward with rowsum(P o dP) dropped from dS =
                     P o (dP - rowsum(P o dP)), in both passes
                     (check_k3_bwd);
  k3_bwd_unsummed    K3's backward storing each window's dS into d bias in
                     place of adding it, so d bias is one window's and not
                     the sum over the windows (check_k3_bwd).
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "psalm_tpu_torch/csrc"
# name: (chip_smoke check, module the check takes, edits (file, old, new))
MUTANTS = {
    "fwd_no_log2e": ("check_k5", "flash_attention", [
        (f"{CSRC}/flash_attention.cu",
         "lse, L, scale * log2e, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32",
         "lse, L, scale, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32")]),
    "bwd_no_delta": ("check_k5_bwd", "flash_attention", [
        (f"{CSRC}/flash_attention_bwd.cu",
         "float ds = p * (dp[b][e] - dt[col]);", "float ds = p * dp[b][e];"),
        (f"{CSRC}/flash_attention_bwd.cu",
         "p * (dp[b][e] - di[r]);", "p * dp[b][e];")]),
    "k1_swap_fractions": ("check_k1", "msdeform", [
        (f"{CSRC}/msdeform_common.cuh", "c.w[1] = scale * (gy * t.fx);",
         "c.w[1] = scale * (gx * t.fy);"),
        (f"{CSRC}/msdeform_common.cuh", "c.w[2] = scale * (t.fy * gx);",
         "c.w[2] = scale * (t.fx * gy);")]),
    "k2_loc_x_fx": ("check_k2", "msdeform", [
        (f"{CSRC}/msdeform_bwd.cu",
         "s_x += g[e] * (gy * (v01 - v00) + t.fy * (v11 - v10));",
         "s_x += g[e] * (gx * (v01 - v00) + t.fx * (v11 - v10));")]),
    "k2_swap_w01_w10": ("check_k2", "msdeform", [
        (f"{CSRC}/msdeform_bwd.cu", "const float aw = a * c.w[k];",
         "const float aw = a * c.w[k == 1 ? 2 : k == 2 ? 1 : k];")]),
    "k3_no_scale": ("check_k3", "swin_attention", [
        (f"{CSRC}/swin_attention.cu",
         "__floats2bfloat162_rn(f.x * scale, f.y * scale)",
         "__floats2bfloat162_rn(f.x, f.y)")]),
    "k3_no_bias": ("check_k3", "swin_attention", [
        (f"{CSRC}/swin_attention.cu",
         "add = __ldg(reinterpret_cast<const float2*>(bh + at + col));",
         "add = make_float2(0.f, 0.f);"),
        (f"{CSRC}/swin_attention.cu",
         "add.x = __ldg(bh + at + col) + ", "add.x = "),
        (f"{CSRC}/swin_attention.cu",
         "add.y = __ldg(bh + at + col + 1) + ", "add.y = ")]),
    "k4_high_scale_low": ("check_k4", "int4_matvec", [
        (f"{CSRC}/int4_matvec.cu",
         "static_cast<long long>((half + r) / group) * N + n0;",
         "static_cast<long long>(r / group) * N + n0;")]),
    "k3_bwd_no_rowsum": ("check_k3_bwd", "swin_attention", [
        (f"{CSRC}/swin_attention_bwd.cu",
         "const float ds = p * (dp - dsum);", "const float ds = p * dp;"),
        (f"{CSRC}/swin_attention_bwd.cu",
         "const float ds = p * (dp - row_dot[i]);",
         "const float ds = p * dp;")]),
    "k3_bwd_unsummed": ("check_k3_bwd", "swin_attention", [
        (f"{CSRC}/swin_attention_bwd.cu", "atomicAdd(dbh + at, ds);",
         "dbh[at] = ds;")]),
}


def run_mutant(name, check, module, edits):
    """Exit code and last lines of chip_smoke's ``check`` on a broken copy."""
    work = tempfile.mkdtemp(prefix=f"mutant_{name}_")
    try:
        dst = os.path.join(work, "repo")
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
            "build", ".git", "__pycache__"))
        for path, old, new in edits:
            src = os.path.join(dst, path)
            with open(src) as f:
                text = f.read()
            if text.count(old) != 1:
                sys.exit(f"{name}: the text to break is not in {path} once")
            with open(src, "w") as f:
                f.write(text.replace(old, new))
        code = ("import sys, torch; sys.path.insert(0, '.'); "
                "import chip_smoke as c; "
                f"from psalm_tpu_torch.ops import {module} as m; "
                f"c.{check}(torch, m, [])")
        proc = subprocess.run([sys.executable, "-c", code], cwd=dst,
                              capture_output=True, text=True, timeout=1200)
        return proc.returncode, (proc.stdout + proc.stderr).splitlines()[-4:]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    passed = []
    names = sys.argv[1:] or list(MUTANTS)
    for name in names:
        check, module, edits = MUTANTS[name]
        rc, tail = run_mutant(name, check, module, edits)
        print(f"== mutant {name}: {check} exit {rc}", flush=True)
        print("\n".join(tail), flush=True)
        if rc == 0:
            passed.append(name)
    if passed:
        sys.exit(f"mutants not caught: {passed}")
    print("every mutant failed its check")


if __name__ == "__main__":
    main()
