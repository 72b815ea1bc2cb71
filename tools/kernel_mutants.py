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
  k3_bwd_no_rowsum   the bf16 K3 backward with rowsum(P o dP) dropped from
                     dS = P o (dP - rowsum(P o dP)) (check_k3_bwd);
  k3_bwd_unsummed    the bf16 K3 backward's d bias sum taking one group's
                     partial in place of the sum of the groups' partials
                     (check_k3_bwd);
  k1_k2_one_radius   K1 and K2 clamping every sampling point at the first
                     point's radius in place of its own (check_point_radii,
                     radii 2, 4, 6, 8);
  k6_no_v_update     K6 without the column duals' update v += spc - minval
                     (check_k6);
  k7_ties_to_higher_id  K7 packing p in place of N - 1 - p into its bid
                     keys: an object goes to the highest person id among
                     its equal top bids in place of the lowest (check_k7).
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "psalm_tpu_torch/csrc"
# name: (chip_smoke check, module of psalm_tpu_torch the check takes, edits
# (file, old, new))
MUTANTS = {
    "fwd_no_log2e": ("check_k5", "ops.flash_attention", [
        (f"{CSRC}/flash_attention.cu",
         "lse, L, scale * log2e, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32",
         "lse, L, scale, causal);\n  return cudaGetLastError();\n}"
         "\n\n// ---- f32")]),
    "bwd_no_delta": ("check_k5_bwd", "ops.flash_attention", [
        (f"{CSRC}/flash_attention_bwd.cu",
         "float ds = p * (dp[b][e] - dt[col]);", "float ds = p * dp[b][e];"),
        (f"{CSRC}/flash_attention_bwd.cu",
         "p * (dp[b][e] - di[r]);", "p * dp[b][e];")]),
    "k1_swap_fractions": ("check_k1", "ops.msdeform", [
        (f"{CSRC}/msdeform_common.cuh", "c.w[1] = scale * (gy * t.fx);",
         "c.w[1] = scale * (gx * t.fy);"),
        (f"{CSRC}/msdeform_common.cuh", "c.w[2] = scale * (t.fy * gx);",
         "c.w[2] = scale * (t.fx * gy);")]),
    "k2_loc_x_fx": ("check_k2", "ops.msdeform", [
        (f"{CSRC}/msdeform_bwd.cu",
         "s_x += g[e] * (gy * (v01 - v00) + t.fy * (v11 - v10));",
         "s_x += g[e] * (gx * (v01 - v00) + t.fx * (v11 - v10));")]),
    "k2_swap_w01_w10": ("check_k2", "ops.msdeform", [
        (f"{CSRC}/msdeform_bwd.cu", "const float aw = a * c.w[k];",
         "const float aw = a * c.w[k == 1 ? 2 : k == 2 ? 1 : k];")]),
    "k3_no_scale": ("check_k3", "ops.swin_attention", [
        (f"{CSRC}/swin_attention.cu",
         "__floats2bfloat162_rn(f.x * scale, f.y * scale)",
         "__floats2bfloat162_rn(f.x, f.y)")]),
    "k3_no_bias": ("check_k3", "ops.swin_attention", [
        (f"{CSRC}/swin_attention.cu",
         "add = __ldg(reinterpret_cast<const float2*>(bh + at + col));",
         "add = make_float2(0.f, 0.f);"),
        (f"{CSRC}/swin_attention.cu",
         "add.x = __ldg(bh + at + col) + ", "add.x = "),
        (f"{CSRC}/swin_attention.cu",
         "add.y = __ldg(bh + at + col + 1) + ", "add.y = ")]),
    "k4_high_scale_low": ("check_k4", "ops.int4_matvec", [
        (f"{CSRC}/int4_matvec.cu",
         "static_cast<long long>((half + r) / group) * N + n0;",
         "static_cast<long long>(r / group) * N + n0;")]),
    "k3_bwd_no_rowsum": ("check_k3_bwd", "ops.swin_attention", [
        (f"{CSRC}/swin_attention_bwd.cu",
         "s[b + c][2 * r] * (dp[c][2 * r] - dsum[r]);",
         "s[b + c][2 * r] * dp[c][2 * r];"),
        (f"{CSRC}/swin_attention_bwd.cu",
         "s[b + c][2 * r + 1] * (dp[c][2 * r + 1] - dsum[r]);",
         "s[b + c][2 * r + 1] * dp[c][2 * r + 1];")]),
    "k3_bwd_unsummed": ("check_k3_bwd", "ops.swin_attention", [
        (f"{CSRC}/swin_attention_bwd.cu", "sum += p[i * nn];",
         "sum = p[i * nn];")]),
    "k1_k2_one_radius": ("check_point_radii", "ops.msdeform", [
        (f"{CSRC}/msdeform_common.cuh", "const float radius = radii.r[p];",
         "const float radius = radii.r[0];")]),
    "k6_no_v_update": ("check_k6", "train.lap", [
        (f"{CSRC}/lap.cu",
         "v[k] = __fadd_rn(v[k], sc ? __fsub_rn(spc[k], minval) : 0.f);",
         "v[k] = __fadd_rn(v[k], 0.f);")]),
    "k7_ties_to_higher_id": ("check_k7", "train.auction", [
        (f"{CSRC}/auction.cu", "static_cast<unsigned>(N - 1 - p);",
         "static_cast<unsigned>(p);"),
        (f"{CSRC}/auction.cu",
         "return N - 1 - static_cast<int>(static_cast<unsigned>(key));",
         "return static_cast<int>(static_cast<unsigned>(key));")]),
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
                f"import psalm_tpu_torch.{module} as m; "
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
