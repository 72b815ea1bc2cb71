#!/usr/bin/env python3
"""Where K1's, K2's, K3's and K4's time goes: each kernel timed beside
copies of itself with one part taken out or changed, in turns, on one card.

    python3 tools/kernel_variants.py [K1 K2 K3 K4]   # from the root of a
                                                     # checkout; one card

A variant is the kernel's source with a few lines replaced, built alone by
nvcc into a temporary directory and called through its C entry point at
the shapes chip_smoke.py checks, bf16. A variant with a part taken out
computes a wrong result; only its time is read. Times are device ms from
torch.profiler (chip_smoke.device_ms), in turns: the kernel as it is, each
variant, the kernel again. With no argument every kernel is timed.
  K1 (phase 3's sampler inputs, bf16, exact and radius 8):
    scalar_loads   each corner's 8 channels read by eight 2-byte loads in
                   place of one 16-byte load
  K2 (the same inputs with an output gradient, bf16, and f32 for the
  first three; a call's time takes in the accumulator's zero fill and, in
  bf16, the finish kernel):
    scalar_atomics d value by scalar atomicAdd, four a vector reduction
    no_scatter     the d value reductions taken out
    split_sectors  (bf16) a thread's two vector reductions to its own
                   channels 8c and 8c + 4 of the head's row in place of 4c
                   and D/2 + 4c: each warp instruction then covers half of
                   every 32-byte sector it touches
    two_blocks     at most 128 registers, two blocks an SM
    blocks_128     blocks of 128 threads in place of 256
  K4 (Phi's three shapes, B = 1 and 4):
    no_products  the unpack, the products and the scales replaced by a
                 cheap use of the loaded words: the loads and the launch
    no_cluster   the cluster barriers and the sum over the ranks taken out
    neither      both
    pieces_16    pieces of 16 packed rows (the plan follows)
    cluster_4, cluster_2, cluster_1  a smaller cluster (the plan's cap)
  K3 (Swin-B's four stages of a 1024^2 image, with and without the mask):
    one_block    no minimum of two blocks an SM in the launch bounds
    no_bias      the bias and mask loads replaced by zeros
"""

import ctypes
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from psalm_tpu_torch.models.quant import quantize_kernel_int4  # noqa: E402
from psalm_tpu_torch.models.swin import shift_attn_mask  # noqa: E402
from psalm_tpu_torch.ops import _build  # noqa: E402
from psalm_tpu_torch.ops import int4_matvec as k4  # noqa: E402
from psalm_tpu_torch.ops import msdeform as k1  # noqa: E402

K4_NO_PRODUCTS = [(
    """      float p[BS][kCols];
      piece_dots<BS, RPT, false>(w, xl, p);
      scale_into<BS>(acc, p, sl);
      piece_dots<BS, RPT, true>(w, xh, p);
      scale_into<BS>(acc, p, sh);""",
    """#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[0][i % kCols] += __uint_as_float(
            (w[i].x ^ w[i].y ^ w[i].z ^ w[i].w) & 0x3fffffffu) + xl[0][i] +
            xh[0][i];
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) acc[0][q] += sl[q].x + sh[q].y;""")]
K4_NO_CLUSTER = [
    ("  cluster.sync();\n  // every rank sums",
     "  __syncthreads();\n  // every rank sums"),
    ("    for (int r = 0; r < ranks; ++r) v += cluster.map_shared_rank(part, r)[e];",
     "    v = part[e];"),
    ("  cluster.sync();  // no block leaves", "  // no block leaves")]
# name: (edits, packed rows a piece, cluster cap)
K4_VARIANTS = {
    "as it is": ([], 8, 8),
    "no_products": (K4_NO_PRODUCTS, 8, 8),
    "no_cluster": (K4_NO_CLUSTER, 8, 8),
    "neither": (K4_NO_PRODUCTS + K4_NO_CLUSTER, 8, 8),
    "pieces_16": ([("constexpr int kRows = 8;", "constexpr int kRows = 16;")],
                  16, 8),
    "cluster_4": ([], 8, 4),
    "cluster_2": ([], 8, 2),
    "cluster_1": ([], 8, 1),
}
K1_VARIANTS = {
    "as it is": [],
    "scalar_loads": [("msdeform_common.cuh",
                      "    return __ldg(reinterpret_cast<const uint4*>(p));",
                      """    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = __ldg(h + i);
    return make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16, u[4] | u[5] << 16,
                      u[6] | u[7] << 16);""")],
}
K2_VARIANTS = {
    "as it is": [],
    "scalar_atomics": [("""      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                   :: "l"(__cvta_generic_to_global(p + i / 4 * stride)),
                      "f"(v[i]), "f"(v[i + 1]), "f"(v[i + 2]), "f"(v[i + 3])
                   : "memory");""",
                        """      for (int j = 0; j < 4; ++j)
        atomicAdd(p + i / 4 * stride + j, v[i + j]);""")],
    "no_scatter": [("      reduce_add<kV>(gv + c.pix[k] * MD, stride, d);",
                    "      (void)d;")],
    "split_sectors": [("const int acc_off = kV == 8 ? 4 * lane_in_head : d0, "
                       "acc_stride = D / 2;",
                       "const int acc_off = d0, acc_stride = 4;")],
    "two_blocks": [("__launch_bounds__(256) msdeform_bwd_kernel",
                    "__launch_bounds__(256, 2) msdeform_bwd_kernel")],
    "blocks_128": [("  constexpr int kThreads = 256;",
                    "  constexpr int kThreads = 128;")],
}
K2_F32 = ("as it is", "scalar_atomics", "no_scatter")
ENTRIES = {"msdeform.cu": "psalm_msdeform_fwd",
           "msdeform_bwd.cu": "psalm_msdeform_bwd",
           "int4_matvec.cu": "psalm_int4_matvec",
           "swin_attention.cu": "psalm_window_attention_fwd"}
K3_VARIANTS = {
    "as it is": [],
    "one_block": [("__launch_bounds__(16 * NB, NB <= 18 ? 2 : 1)",
                   "__launch_bounds__(16 * NB)")],
    "no_bias": [
        ("add = __ldg(reinterpret_cast<const float2*>(bh + at + col));",
         "add = make_float2(0.f, 0.f);"),
        ("const float2 m = __ldg(reinterpret_cast<const float2*>(mw + at + col));",
         "const float2 m = make_float2(0.f, 0.f);")],
}


def build(work, source, variants):
    """{name: loaded library} of each variant of csrc/``source``. An edit
    is (old, new) in the source, or (header, old, new) in a header."""
    csrc = _build.CSRC_DIR
    nvcc = _build.find_nvcc()
    cmds, paths = [], {}
    for name, edits in variants.items():
        vdir = os.path.join(work, f"{source[:-3]}_{name.replace(' ', '_')}")
        os.makedirs(vdir)
        files = {p.name: p.read_text() for p in csrc.glob("*.cuh")}
        files[source] = (csrc / source).read_text()
        for edit in edits:
            where, old, new = edit if len(edit) == 3 else (source, *edit)
            if files[where].count(old) != 1:
                sys.exit(f"{where} {name}: the text to replace is not there "
                         "once")
            files[where] = files[where].replace(old, new)
        for fname, text in files.items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        paths[name] = os.path.join(vdir, "lib.so")
        cmds.append(_build.nvcc_command(nvcc, [os.path.join(vdir, source)],
                                        paths[name]))
    _build._run_together(cmds)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        getattr(lib, ENTRIES[source]).argtypes = _build.SIGNATURES[ENTRIES[source]]
        libs[name] = lib
    return libs


def in_turns(names):
    """The kernel as it is, each variant, the kernel again."""
    base = names[0]
    return [base] + names[1:] + [base]


def time_k4(libs):
    g = torch.Generator(device="cuda").manual_seed(4)
    for K, N, which in smoke.K4_SHAPES:
        w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
        packed, scale = quantize_kernel_int4(w, 64)
        for B in (1, 4):
            x = torch.randn(B, K, generator=g, device="cuda").bfloat16()
            out = torch.empty(B, N, device="cuda")
            for name in in_turns(list(K4_VARIANTS)):
                _, piece, cap = K4_VARIANTS[name]
                k4.PIECE_ROWS, k4.MAX_CLUSTER = piece, cap
                k4.plan.cache_clear()
                cluster, tc, rows = k4.plan(B, K, N, 64)
                lib = libs["as it is" if name.startswith("cluster") else name]

                def call():
                    rc = lib.psalm_int4_matvec(
                        x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), _build.DTYPE_CODES[x.dtype], B, K, N,
                        64, cluster, tc, rows, _build.stream_ptr(x.device))
                    if rc:
                        sys.exit(f"K4 {name}: CUDA error {rc}")

                ms = smoke.device_ms(call, iters=50)
                print(f"K4 {which} B={B} {name} (cluster {cluster}, "
                      f"{16 * tc} columns a block): {ms:.5f} ms", flush=True)
    k4.PIECE_ROWS, k4.MAX_CLUSTER = 8, 8
    k4.plan.cache_clear()


def time_k3(libs):
    g = torch.Generator(device="cuda").manual_seed(3)
    ws, N = 12, 144
    for stage, (res, C, h) in enumerate(((256, 128, 4), (128, 256, 8),
                                         (64, 512, 16), (32, 1024, 32))):
        Hp = -(-res // ws) * ws
        nW = (Hp // ws) ** 2
        qkv = torch.randn(nW, N, 3 * C, generator=g, device="cuda").bfloat16()
        bias = torch.randn(h, N, N, generator=g, device="cuda")
        mask = torch.from_numpy(shift_attn_mask(Hp, Hp, ws, ws // 2)).cuda()
        out = torch.empty(nW, N, C, dtype=torch.bfloat16, device="cuda")
        for m in (None, mask):
            for name in in_turns(list(K3_VARIANTS)):
                lib = libs[name]

                def call():
                    rc = lib.psalm_window_attention_fwd(
                        qkv.data_ptr(), bias.data_ptr(),
                        m.data_ptr() if m is not None else None,
                        out.data_ptr(), _build.DTYPE_CODES[qkv.dtype], nW, N,
                        C, h, m.shape[0] if m is not None else 1,
                        (C // h) ** -0.5, _build.stream_ptr(qkv.device))
                    if rc:
                        sys.exit(f"K3 {name}: CUDA error {rc}")

                ms = smoke.device_ms(call, iters=50)
                print(f"K3 stage{stage} {'shift-mask' if m is not None else 'no-mask'}"
                      f" {name}: {ms:.5f} ms", flush=True)


def deform_call(lib, name, dtype, radius, backward):
    """A call of K1 (or K2) from ``lib`` on phase 3's inputs in ``dtype``."""
    shapes, loc, value32, attn32, g = smoke.deform_inputs(torch, 2, True)
    B, S, M, D = value32.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    value, attn = value32.to(dtype), attn32.to(dtype)
    grad = torch.randn(B, S, M * D, generator=g, device="cuda").to(dtype)
    ref = k1.reference_grid(shapes)
    ref = torch.from_numpy(ref).cuda()
    shapes_c = k1._shapes_c(shapes)
    radii_c = k1._radii_c(k1.point_radii(radius, P))
    common = (_build.DTYPE_CODES[dtype], B, S, Q, M, D, L, P, shapes_c,
              radii_c, _build.stream_ptr(value.device))
    if backward:
        grad_value = torch.empty_like(value)
        acc = torch.empty(B, S, M, D, device="cuda")
        grad_loc, grad_attn = torch.empty_like(loc), torch.empty_like(attn)
        ptrs = (value, loc, attn, ref, grad, grad_value, acc, grad_loc,
                grad_attn)
        entry = lib.psalm_msdeform_bwd
    else:
        out = torch.empty(B, Q, M * D, dtype=dtype, device="cuda")
        ptrs = (value, loc, attn, ref, out)
        entry = lib.psalm_msdeform_fwd

    def call():
        rc = entry(*(t.data_ptr() for t in ptrs), *common)
        if rc:
            sys.exit(f"{'K2' if backward else 'K1'} {name}: CUDA error {rc}")

    return call


def time_deform(libs, kernel, cases):
    """K1 or K2 in each (dtype, radius, variants) case, in turns."""
    for dtype, radius, names in cases:
        for name in in_turns(list(names)):
            call = deform_call(libs[name], name, dtype, radius, kernel == "K2")
            ms = smoke.device_ms(call, iters=50)
            print(f"{kernel} {smoke.dtype_name(dtype)} radius={radius} {name}: "
                  f"{ms:.5f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    which = sys.argv[1:] or ["K1", "K2", "K3", "K4"]
    print(torch.cuda.get_device_name(0), flush=True)
    work = tempfile.mkdtemp(prefix="kernel_variants_")
    try:
        if "K1" in which:
            libs = build(work, "msdeform.cu", K1_VARIANTS)
            time_deform(libs, "K1", [(torch.bfloat16, r, K1_VARIANTS)
                                     for r in (None, 8.0)])
        if "K2" in which:
            libs = build(work, "msdeform_bwd.cu", K2_VARIANTS)
            time_deform(libs, "K2", [(torch.bfloat16, None, K2_VARIANTS),
                                     (torch.float32, None, K2_F32)])
        if "K4" in which:
            k4_libs = build(work, "int4_matvec.cu",
                            {n: e for n, (e, _, _) in K4_VARIANTS.items()
                             if not n.startswith("cluster")})
            time_k4(k4_libs)
        if "K3" in which:
            time_k3(build(work, "swin_attention.cu", K3_VARIANTS))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
