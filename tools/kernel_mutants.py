#!/usr/bin/env python3
"""Mutation check of the kernels: does chip_smoke.py's limit catch a wrong
kernel?

    python3 tools/kernel_mutants.py      # from the root of a checkout; one card

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
  k1_swap_fractions  K1 with its bilinear fractions fx and fy swapped
                     (check_k1);
  k3_no_scale        the bf16 tensor-core K3 without q's scale (check_k3);
  k3_no_bias         the bf16 tensor-core K3 without the relative-position
                     bias (check_k3);
  k4_high_scale_low  K4 reading the high half's group scale from the low
                     half's row (check_k4).
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "psalm_tpu_torch/csrc"
# name: (source, chip_smoke check, module the check takes, edits)
MUTANTS = {
    "fwd_no_log2e": (f"{CSRC}/flash_attention.cu", "check_k5",
                     "flash_attention", [
        ("lse, L, scale * log2e, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32",
         "lse, L, scale, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32")]),
    "bwd_no_delta": (f"{CSRC}/flash_attention_bwd.cu", "check_k5_bwd",
                     "flash_attention", [
        ("float ds = p * (dp[b][e] - dt[col]);", "float ds = p * dp[b][e];"),
        ("p * (dp[b][e] - di[r]);", "p * dp[b][e];")]),
    "k1_swap_fractions": (f"{CSRC}/msdeform.cu", "check_k1", "msdeform", [
        ("const float fx = t.fx, fy = t.fy;",
         "const float fx = t.fy, fy = t.fx;")]),
    "k3_no_scale": (f"{CSRC}/swin_attention.cu", "check_k3", "swin_attention",
                    [("__floats2bfloat162_rn(f.x * scale, f.y * scale)",
                      "__floats2bfloat162_rn(f.x, f.y)")]),
    "k3_no_bias": (f"{CSRC}/swin_attention.cu", "check_k3", "swin_attention", [
        ("add = __ldg(reinterpret_cast<const float2*>(bh + at + col));",
         "add = make_float2(0.f, 0.f);"),
        ("add.x = __ldg(bh + at + col) + ", "add.x = "),
        ("add.y = __ldg(bh + at + col + 1) + ", "add.y = ")]),
    "k4_high_scale_low": (f"{CSRC}/int4_matvec.cu", "check_k4", "int4_matvec", [
        ("static_cast<long long>((half + r) / group) * N + n0;",
         "static_cast<long long>(r / group) * N + n0;")]),
}


def run_mutant(name, path, check, module, edits):
    """Exit code and last lines of chip_smoke's ``check`` on a broken copy."""
    work = tempfile.mkdtemp(prefix=f"mutant_{name}_")
    try:
        dst = os.path.join(work, "repo")
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
            "build", ".git", "__pycache__"))
        src = os.path.join(dst, path)
        with open(src) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"{name}: the text to break is not in {path} once")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
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
    for name, (path, check, module, edits) in MUTANTS.items():
        rc, tail = run_mutant(name, path, check, module, edits)
        print(f"== mutant {name}: {check} exit {rc}", flush=True)
        print("\n".join(tail), flush=True)
        if rc == 0:
            passed.append(name)
    if passed:
        sys.exit(f"mutants not caught: {passed}")
    print("every mutant failed its check")


if __name__ == "__main__":
    main()
