#!/usr/bin/env python3
"""Mutation check of the bf16 K5 kernels: does chip_smoke.py's limit catch
a wrong kernel?

    python3 tools/k5_mutants.py      # from the root of a checkout; one card

For each mutant, the checkout is copied to a temporary directory outside
it, one kernel source is broken there, and chip_smoke.py's check of that
kernel runs on the copy (building the copy's kernels). Each must fail; the
script prints the lines where it did and exits nonzero if a mutant passed.
  fwd_no_log2e  the tensor-core forward with log2 e dropped from the
                logits' scale: exp2 of the plain logits, a softmax at the
                wrong temperature (check_k5);
  bwd_no_delta  the tensor-core backward without D = rowsum(dO O) in
                dS = P (dP - D), in both its kernels (check_k5_bwd).
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "psalm_tpu_torch/csrc"
MUTANTS = {
    "fwd_no_log2e": (f"{CSRC}/flash_attention.cu", "check_k5", [
        ("lse, L, scale * log2e, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32",
         "lse, L, scale, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32")]),
    "bwd_no_delta": (f"{CSRC}/flash_attention_bwd.cu", "check_k5_bwd", [
        ("float ds = p * (dp[b][e] - dt[col]);", "float ds = p * dp[b][e];"),
        ("p * (dp[b][e] - di[r]);", "p * dp[b][e];")]),
}


def run_mutant(name, path, check, edits):
    """Exit code and last lines of chip_smoke's ``check`` on a broken copy."""
    work = tempfile.mkdtemp(prefix=f"k5_{name}_")
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
                "from psalm_tpu_torch.ops import flash_attention as fa; "
                f"c.{check}(torch, fa, [])")
        proc = subprocess.run([sys.executable, "-c", code], cwd=dst,
                              capture_output=True, text=True, timeout=1200)
        return proc.returncode, (proc.stdout + proc.stderr).splitlines()[-4:]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    passed = []
    for name, (path, check, edits) in MUTANTS.items():
        rc, tail = run_mutant(name, path, check, edits)
        print(f"== mutant {name}: {check} exit {rc}", flush=True)
        print("\n".join(tail), flush=True)
        if rc == 0:
            passed.append(name)
    if passed:
        sys.exit(f"mutants not caught: {passed}")
    print("every mutant failed its check")


if __name__ == "__main__":
    main()
