"""Time ablated copies of K4-fp32, K1-fp32 at dh 128, K2, K7, K8, K8-fp32, K9
and K9-fp32 (forward and backward) and K11 on the card, and the pieces of K5
and K6: what holds each back.

Each variant is a copy of the kernel's source with one piece of its work
taken out by a text substitution, built alone with nvcc (beside
csrc/common.cu) into its own library under ``lam_slide_tpu_torch/_build/``
and called through ctypes on the same inputs at the MD17 shapes: K2's
Hopper route on x [1843200, 256] -> 512 -> 256 (the MLP slices of nn.Linear
weights, as the DiT passes them), K9's forward and backward on packed
[61440, 30, 256] (16 heads of 16, v a view of a wider buffer) and K11 on
head-major views [1920, 16, 192, 16] with K1's out and lse; K8's Hopper
route at the 4AA Euler-10 B=8 shape [8000, 2, 384] at 16 x 24 and 3 x 128
(without the QK norm, RoPE and attention, without any epilogue, without
either GEMM's products, with each weight stage loaded once and then
reused); K4's fp32 kernels (K4_F32_VARIANTS: the narrow kernel at the 4AA
fp32 step's [32, 16, 1000, 24] and the MD17 fp32 DiT's [1920, 16, 192, 16],
the wide one at [16, 3, 1000, 128], [1920, 2, 192, 128] and [12288, 2, 30,
128], TF32 off); K9-fp32's forward and backward at MD17's [12288, 30, 256]
(K9_F32_VARIANTS: without copies in, exponentials, products or stores; on
two stages and with one row a thread, both checked against the kernel's
bits; other geometries: heads an item, threads) and at [256,
127, 256]; K8's fp32 outer-product kernel at the 4AA shapes ([2000, 2,
384] and [8000, 2, 384] at both head splits, [16000, 2, 384] at 16 x 24),
NBA's [20480, 8, 256] and the pedestrian's [5120, 2, 128] (without either
GEMM's products, without the norm, RoPE and attention, with the first
weight slices loaded and then reused, with one slice barrier, on rings of
16-row slices, and in other layouts, K8_F32_LAYOUT), in turns with the
dot-product route at NBA and the pedestrian width; K2's fp32
outer-product kernel (K2_F32_VARIANTS) at MD17's, the 4AA's and the
pedestrian's widths, at the last also beside the dot-product route and by
device time; and K7 with
the residual at the MD17 protocol batch's [320, 30, 192, 256] and the 4AA
[8, 1000, 2, 384] (rows walked in h's order instead of x's, one row a warp
instead of two, without h's loads, without stores); K1's fp32 kernel at dh
128 at MD17's [1920, 2, 192, 128] and the 4AA eval's [4, 3, 1000, 128]
(uncapped registers: one block an SM, 32 query rows a block, without the
K/V tile loads, without the PV products). A variant's
outputs are wrong by design; only its time means anything. Work a variant
skips behind a run-time condition that never holds (``a.R < 0``) is still
compiled, so what it feeds is not optimised away. The variants run in turns
(in order, then in reverse), timed with CUDA events, beside PyTorch's fp32
rowsum(g * out) at K11's shape (the delta the K11 wrapper computed before
its delta kernel). K5 and K6 are compositions of kernels, so their pieces
are timed alone instead, in turns, at the 3 x 128 train step's
[32, 3, 1000, 128] (raw q/k/v head-major views of one packed buffer): the
transform kernel, the redesigned forward on the transformed q/k, K5
whole, the redesigned backward on them, the plain pre-transform's VJP that
chains its grads to the raw q/k and the scales, and K6's backward as the
train step runs it (the two together); the transform's device time from
the profiler too. Each line names the card and its power limit. Run from
a tree's root:

    PYTHONPATH=. python lam_slide_tpu_torch/tools/kernel_variants.py \
        [K4-fp32 K1-fp32-narrow K1-fp32-wide K2-fp32 K2 K9-forward K11 K9-backward K9-fp32
         K5-K6 K8 K8-fp32 K7]
"""

import argparse
import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import flash_normrope as fnr
from lam_slide_tpu_torch.ops import fused_mlp as fm
from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
from lam_slide_tpu_torch.ops import short_attention as tsa
from lam_slide_tpu_torch.ops._grad import plain_vjp

REPS = 20
# variant: [(text in the source, its replacement), ...]
K11_VARIANTS = {
    "kernel": [],
    "no dK/dV stores": [("    write_rows<DV>(dk,", "    if (false) write_rows<DV>(dk,"),
                        ("    write_rows<DV>(dv,", "    if (false) write_rows<DV>(dv,")],
    "no exponential": [("const float p = ex2(fmaf(s[i], c, -(lse[col] * LOG2E)));",
                        "const float p = s[i];")],
    "no dQ": [("if (qc % NW == wg) {", "if (false) {")],
    "no chunk barrier": [("named_sync(1, consumers);  // the slab", "// the slab")],
    "no dK/dV products": [("wgmma_rs<DV, 1>(dv, pf[kk]", "if (false) wgmma_rs<DV, 1>(dv, pf[kk]"),
                          ("wgmma_rs<DV, 1>(dk, df[kk]", "if (false) wgmma_rs<DV, 1>(dk, df[kk]")],
}
# K1's register-tiled fp32 kernel at 64 < dh <= 128: its products, its
# exponentials and its K/V copies taken out one at a time, and 32-row blocks
# (two rows a thread) in place of 64 where one sequence takes a block
K1_F32_WIDE_VARIANTS = {
    "kernel": [],
    "no S products": [("    for (int d = 0; d < WIDE_DP; d += 4) {",
                       "    for (int d = 0; d < (Nq < 0 ? WIDE_DP : 0); d += 4) {")],
    "no PV products": [("    for (int key = kb; key < ke; ++key) {",
                        "    for (int key = kb; key < (Nq < 0 ? ke : kb); ++key) {")],
    "no exponentials": [("        sc[i][j] = expf(sc[i][j] - m_new);",
                         "        sc[i][j] = sc[i][j] - m_new;")],
    "no K/V copies": [("    wide_stage<SEG, VEC>(Ks,", "    if (Nq < 0) wide_stage<SEG, VEC>(Ks,"),
                      ("    wide_stage<SEG, VEC>(Vs,", "    if (Nq < 0) wide_stage<SEG, VEC>(Vs,")],
    "32 rows a block": [("  return launch_f32_tiled<64, 1, VEC>(",
                         "  return launch_f32_tiled<32, 1, VEC>(")],
}
# K2's outer-product fp32 kernel: either GEMM's products, the GELU or the
# slice copies taken out, a ring of two stages (one slice in flight, not
# two), MD17's instance at the other micro-tile (8 x 8 a thread, 512
# threads, so 128 registers a thread) and the pedestrian's in 64-row blocks
# of 256 threads (160 blocks at its 10,240 rows, not 320)
K2_F32_VARIANTS = {
    "kernel": [],
    "no GEMM1 products": [("      for (int k = 0; k < KS; ++k) {",
                           "      for (int k = 0; k < (a.rows < 0 ? KS : 0); ++k) {")],
    "no GEMM2 products": [("      for (int m = 0; m < MS; ++m) {",
                           "      for (int m = 0; m < (a.rows < 0 ? MS : 0); ++m) {")],
    "no GELU": [("g[i] = gelu_exact(__fadd_rn(mid[i][j], b));", "g[i] = __fadd_rn(mid[i][j], b);")],
    "no slice copies": [("    if (u + STAGES - 1 < total) load_slice(u + STAGES - 1);",
                         "    if (a.rows < 0) load_slice(u + STAGES - 1);")],
    "two stages": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "8 x 8 at MD17": [("using Inst256 = Inst<256, 128, 256, 16, 8, 64, 8, 64, 16>;",
                       "using Inst256 = Inst<256, 128, 512, 8, 8, 64, 4, 64, 16>;")],
    "64-row blocks (256 threads, 4 x 8)": [
        ("using Inst128 = Inst<128, 32, 128, 4, 8, 128, 8, 32, 32>;",
         "using Inst128 = Inst<128, 64, 256, 4, 8, 128, 8, 32, 32>;"),
        ("if (d_out == 128 && bm == 32", "if (d_out == 128 && bm == 64")],
}
# the layout variants timed at one d_out alone: d_out -> the rows a block
# they are called with; the others run at every width in the plan's block
K2_F32_LAYOUT = {"8 x 8 at MD17": {256: 128}, "64-row blocks (256 threads, 4 x 8)": {128: 64}}
K2_LOOKUP = "static_cast<uint32_t>(__ldg(table + (in ? k + (h >> 15) * GELU_SPAN : 0u)))"
K2_VARIANTS = {
    "kernel": [],
    "no stores": [("            __stcs(", "            if (a.R < 0) __stcs(")],
    "no GEMM1": [("  for (int p = 0; p < kp; ++p) {", "  for (int p = 0; p < 0 * kp; ++p) {")],
    "no GEMM2": [("wgmma_ss<NO, 0, 0>(o, dm + 2 * kk, dw + 2 * kk, 1);", ";")],
    "GEMM2 half width": [("wgmma_ss<NO, 0, 0>(o, dm + 2 * kk,",
                          "wgmma_ss<NO == 192 ? 64 : NO / 2, 0, 0>(reinterpret_cast<float(&)"
                          "[NO == 192 ? 32 : NO / 4]>(o), dm + 2 * kk,")],
    "no GELU": [(K2_LOOKUP, "h")],
    "GELU by erff": [(K2_LOOKUP, "static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16("
                                 "gelu_fp32(__uint_as_float(h << 16)))))")],
    "GEMMs only": [("          (looked & keep) | (pack_bf16(val[0], val[1]) & ~keep);",
                    "          pack_bf16(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]);"),
                   ("            __stcs(", "            if (a.R < 0) __stcs(")],
    "GELU after GEMM2": [("  wgmma_wait1();  // GEMM1 of chunk c+1 is done;",
                          "  wgmma_wait0();  // GEMM1 of chunk c+1 is done;")],
    "weights loaded once": [
        ("        mbar_arrive_expect_tx(&sm.full1[st], w1_tx);",
         "        if (u >= a.s1) { mbar_arrive(&sm.full1[st]); return; }\n"
         "        mbar_arrive_expect_tx(&sm.full1[st], w1_tx);"),
        ("        mbar_arrive_expect_tx(&sm.full2[st], w2_tx);",
         "        if (u >= S2) { mbar_arrive(&sm.full2[st]); return; }\n"
         "        mbar_arrive_expect_tx(&sm.full2[st], w2_tx);")],
}
K8_EPILOGUES = [("        bias_epilogue<SW>(s, a,", "        if (a.R < 0) bias_epilogue<SW>(s, a,"),
                ("        gelu_epilogue<SW>(s, a,", "        if (a.R < 0) gelu_epilogue<SW>(s, a,")]
K8_ATTENTION = [("      attention<SB, DH>(a, sm.stg);", "      if (a.R < 0) attention<SB, DH>(a, sm.stg);"),
                ("      normrope<SB, DH>(a, sm.stg);", "      if (a.R < 0) normrope<SB, DH>(a, sm.stg);")]
# K8-fp32's outer-product kernel (namespace tiled): either GEMM's products,
# the norm, RoPE and attention, or the slice copies taken out (the first
# slices loaded, then reused), the barrier at the top of a slice kept only
# before the first, rings of 16-row slices three and four stages deep in
# place of two of 32 rows (at every width); at 4AA the other thread
# layouts: 128 threads of 8 x 12, 192 of 8 x 8 and 384 of 4 x 8
# (substituted for 256 of 4 x 12), and blocks of 16 rows (128 threads of
# 4 x 12: twice the blocks, 250 at the eval's 4,000 rows, each streaming all
# the weights); at NBA (64-row blocks of 256 threads at 8 x 8, head groups
# of 64) 32-row blocks of 4 x 8, with head groups of 64 or 128, and 512
# threads of 4 x 8; at the pedestrian width (32-row blocks of 256 threads at
# 4 x 4, head groups of 128) head groups of 64, 128 threads of 4 x 8 and
# 64-row blocks of 8 x 4 at head groups of 64 (at 128, 237,584 bytes)
K8_F32_4AA = ("using I384g96 = Inst<384, 32, 256, 4, 96>;\n"
              "using I384g128 = Inst<384, 32, 256, 4, 128>;")
K8_F32_NBA = "using I256 = Inst<256, 64, 256, 8, 64>;"
K8_F32_PED = "using I128 = Inst<128, 32, 256, 4, 128>;"
K8_F32_RING = ("constexpr int KS = 32;", "constexpr int STAGES = 2;")


def _k8_f32_4aa(threads: int, tm: int, bm: int = 32):
    return [(K8_F32_4AA, f"using I384g96 = Inst<384, {bm}, {threads}, {tm}, 96>;\n"
                         f"using I384g128 = Inst<384, {bm}, {threads}, {tm}, 128>;")]


K8_F32_VARIANTS = {
    "kernel": [],
    "no GEMM1 products": [("  for (int k = 0; k < KS; ++k) {",
                           "  for (int k = 0; k < (cg < 0 ? KS : 0); ++k) {")],
    "no GEMM2 products": [("      for (int kk = 0; kk < MS; ++kk) {",
                           "      for (int kk = 0; kk < (a.n < 0 ? MS : 0); ++kk) {")],
    "no norm, RoPE, attention": [("          attend<I>(st, a, rows);",
                                  "          if (a.n < 0) attend<I>(st, a, rows);")],
    "weights loaded once": [
        ("    if (t == 0 && u + STAGES - 1 < total) load_slice(u + STAGES - 1);",
         "    if (t == 0 && u + STAGES - 1 < total && u < 1) load_slice(u + STAGES - 1);"),
        ("    lam_sm90::mbar_wait(full + u % STAGES, (u / STAGES) & 1);",
         "    if (u < STAGES) lam_sm90::mbar_wait(full + u % STAGES, (u / STAGES) & 1);")],
    "one slice barrier": [("    __syncthreads();  // x^T written, the mbarriers set;",
                           "    if (u == 0) __syncthreads();  // x^T written, the mbarriers set;")],
    "16-row slices, 3 stages": [(K8_F32_RING[0], "constexpr int KS = 16;"),
                                (K8_F32_RING[1], "constexpr int STAGES = 3;")],
    "16-row slices, 4 stages": [(K8_F32_RING[0], "constexpr int KS = 16;"),
                                (K8_F32_RING[1], "constexpr int STAGES = 4;")],
    "128 threads (8 x 12)": _k8_f32_4aa(128, 8),
    "192 threads (8 x 8)": _k8_f32_4aa(192, 8),
    "384 threads (4 x 8)": _k8_f32_4aa(384, 4),
    "16-row blocks (128 threads, 4 x 12)": _k8_f32_4aa(128, 4, 16),
    "32-row blocks (4 x 8)": [(K8_F32_NBA, "using I256 = Inst<256, 32, 256, 4, 64>;")],
    "32-row blocks, head groups of 128": [(K8_F32_NBA,
                                           "using I256 = Inst<256, 32, 256, 4, 128>;")],
    "512 threads (4 x 8)": [(K8_F32_NBA, "using I256 = Inst<256, 64, 512, 4, 64>;")],
    "head groups of 64": [(K8_F32_PED, "using I128 = Inst<128, 32, 256, 4, 64>;")],
    "128 threads (4 x 8)": [(K8_F32_PED, "using I128 = Inst<128, 32, 128, 4, 128>;")],
    "64-row blocks, head groups of 64 (8 x 4)": [(K8_F32_PED,
                                                  "using I128 = Inst<128, 64, 256, 8, 64>;")],
}
# the layout variants (timed at one width: D -> (head group, rows a block)
# they are called with); every other variant is timed at every width at the
# plan's group and block
K8_F32_LAYOUT = {
    "128 threads (8 x 12)": {384: None}, "192 threads (8 x 8)": {384: None},
    "384 threads (4 x 8)": {384: None}, "16-row blocks (128 threads, 4 x 12)": {384: (None, 16)},
    "32-row blocks (4 x 8)": {256: (64, 32)},
    "32-row blocks, head groups of 128": {256: (128, 32)},
    "512 threads (4 x 8)": {256: None},
    "head groups of 64": {128: (64, 32)}, "128 threads (4 x 8)": {128: None},
    "64-row blocks, head groups of 64 (8 x 4)": {128: (64, 64)},
}
# K1's narrow fp32 kernel (dh <= 64): its S or PV products, its
# exponentials, its K/V tile copies or its partial outputs' epilogue taken
# out, two, three or one blocks an SM at every dh (the kernel: three at
# dh <= 16, two above), and 64-key tiles where Nk <= 32 takes 32
K1_F32_NARROW_VARIANTS = {
    "kernel": [],
    "no S products": [("    for (int d = 0; d < DP; d += 4) {\n      float4 qv[4];",
                       "    for (int d = 0; d < (Nq < 0 ? DP : 0); d += 4) {\n"
                       "      float4 qv[4];")],
    "no PV products": [("    for (int kk = kb; kk < ke; ++kk) {",
                        "    for (int kk = kb; kk < (Nq < 0 ? ke : kb); ++kk) {")],
    "no exponentials": [("        const float p = expf(sc[i][j] - m_new);",
                         "        const float p = sc[i][j] - m_new;")],
    "no K/V copies": [("    narrow_fwd_stage<DP, VEC>(nfs + L::k_off",
                       "    if (Nq < 0) narrow_fwd_stage<DP, VEC>(nfs + L::k_off"),
                      ("    narrow_fwd_stage<DP, VEC>(nfs + L::v_off",
                       "    if (Nq < 0) narrow_fwd_stage<DP, VEC>(nfs + L::v_off")],
    "no partial-output epilogue": [("    if (q0 + r >= Nq || c >= dh) continue;",
                                    "    if (q0 + r >= Nq || c >= dh || Nq > 0) continue;")],
    "two blocks an SM": [("return DP <= 16 ? 3 : 2;", "return 2;")],
    "three blocks an SM": [("return DP <= 16 ? 3 : 2;", "return 3;")],
    "one block an SM": [("return DP <= 16 ? 3 : 2;", "return 1;")],
    "64-key tiles at Nk <= 32": [("    return keys == 32 ? launch_f32_narrow<DP, 32, VEC>",
                                  "    return keys == 0 ? launch_f32_narrow<DP, 32, VEC>")],
}
K8_VARIANTS = {
    "kernel": [],
    "no norm, RoPE, attention": K8_ATTENTION,
    "no epilogues at all": K8_EPILOGUES + K8_ATTENTION,
    "no linear1 products": [("      wgmma_ss<N, 0, 0>(s, dx", "      if (a.R < 0) wgmma_ss<N, 0, 0>(s, dx")],
    "no linear2 products": [("      wgmma_ss<NO, 0, 0>(o, da", "      if (a.R < 0) wgmma_ss<NO, 0, 0>(o, da")],
    "weights loaded once": [
        ("            mbar_arrive_expect_tx(&sm.full1[st], sm.w1_stage);",
         "            if (u1 >= a.s1) { mbar_arrive(&sm.full1[st]); continue; }\n"
         "            mbar_arrive_expect_tx(&sm.full1[st], sm.w1_stage);"),
        ("          mbar_arrive_expect_tx(&sm.full2[st], 2 * box2);",
         "          if (u2 >= a.s2) { mbar_arrive(&sm.full2[st]); continue; }\n"
         "          mbar_arrive_expect_tx(&sm.full2[st], 2 * box2);")],
}
K7_VARIANTS = {
    "kernel": [],
    "rows in h's order": [("        xr[q] = row;", "        xr[q] = row % a.R1 * a.R2 + row / a.R1;")],
    "one row a warp": [("constexpr int RPW = 2;", "constexpr int RPW = 1;")],
    "no h loads": [("          if constexpr (RESIDUAL) load_vec<VEC>(hrow",
                    "          if constexpr (RESIDUAL) if (a.R1 < 0) load_vec<VEC>(hrow")],
    "no stores": [("            store_vec<VEC>(orow", "            if (a.R1 < 0) store_vec<VEC>(orow"),
                  ("          store_vec<VEC>(yrow", "          if (a.R1 < 0) store_vec<VEC>(yrow")],
}
K9_FWD_VARIANTS = {
    "kernel": [],
    "loads and stores only": [("    if (warp < nh)\n      head_fwd<DP>(",
                               "    if (a.n < 0)\n      head_fwd<DP>(")],
    "no stores": [("    move_rows<DP, false>(out_tile,",
                   "    if (a.n < 0) move_rows<DP, false>(out_tile,")],
    "no exponential": [("l[r] *= ex2(m[r] - mn);", "l[r] *= m[r] - mn;"),
                       ("l[r] += ex2(s[j][2 * r + e] - mn);", "l[r] += s[j][2 * r + e] - mn;"),
                       ("__fmul_rn(ex2(s[j][e] - m[e / 2]), inv[e / 2]);",
                        "__fmul_rn(s[j][e] - m[e / 2], inv[e / 2]);")],
    "no AV": [("        mma_rows<1, DP / 8>(acc, a, V, rs,",
               "        if (a[0][0] == 0x7fffffffu) mma_rows<1, DP / 8>(acc, a, V, rs,")],
}
K9_VARIANTS = {
    "kernel": [],
    "loads and stores only": [("    if (h0 + warp < a.H) {\n", "    if (false) {\n")],
    "math and stores only": [
        ("  if (t < items) load_item<DP>(a, smem, t);", ""),
        ("    if (t + gridDim.x < items) load_item<DP>(a, smem + ((j & 1) ^ 1) * 4 * te, "
         "t + gridDim.x);", "")],
}


# K4's fp32 kernels (csrc/flash_attention_bwd.cu), each one pass over a key
# tile's queries: the narrow kernel's S and dP products, its dK/dV products,
# its query tiles' copies, its exponentials or its partial sums' epilogue
# taken out, or one block an SM (no register cap); either kernel without its
# dQ shares' products or without their sum. Each variant builds the whole
# file.
K4_F32_VARIANTS = {
    "kernel": [],
    "no S/dP products": [("  for (int d = 0; d < DP; d += 4) {",
                          "  for (int d = 0; d < (X == Y ? DP : 0); d += 4) {")],
    "no dK/dV products": [
        ("      narrow_axpy<CN>(dv, ", "      if (a.Nq < 0) narrow_axpy<CN>(dv, "),
        ("      narrow_axpy<CN>(dk, ", "      if (a.Nq < 0) narrow_axpy<CN>(dk, ")],
    "no query tile copies": [
        ("    narrow_stage<DP, VEC>(Qn, qp,", "    if (a.Nq < 0) narrow_stage<DP, VEC>(Qn, qp,"),
        ("    narrow_stage<DP, VEC>(Qn + L::tile, dop,",
         "    if (a.Nq < 0) narrow_stage<DP, VEC>(Qn + L::tile, dop,")],
    "no exponentials": [("        p[i] = expf(__fsub_rn(s, lse));", "        p[i] = __fsub_rn(s, lse);")],
    "no partial-sum epilogue": [("    if (n0 + r >= n || c >= dh) continue;",
                                 "    if (n0 + r >= n || c >= dh || n > 0) continue;")],
    "one block an SM": [("__launch_bounds__(NB_THREADS, 2)", "__launch_bounds__(NB_THREADS, 1)")],
    "without dQ shares": [("  for (int kk = kb; kk < ke; kk += 4) {",
                           "  for (int kk = kb; kk < (a.Nq < 0 ? ke : kb); kk += 4) {", 2)],
    "without their sum": [("  if (err != cudaSuccess || a.scratch == nullptr) return err;",
                           "  return err;")],
}
# K9-fp32's kernels (csrc/short_attention_f32.cu): each variant builds the
# whole file, and the forward and the backward are timed on it. Their
# copies in (both kernels' ``load``), their exponentials, their products
# (the forward's logits and AV; the backward's S and dP, and its grads) or
# their stores taken out; the backward without S and dP alone. Two variants
# compute the same outputs another way and are held to the kernel's bits
# (K9_F32_EXACT): two stages (the next item's copies in flight while this
# one computes, twice the tiles) and, in the forward, one query row a
# thread at n <= 64.
K9_F32_LOAD = "  auto load = [&](long long item, float* base) {\n"
K9_F32_ONE_STAGE = """  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    float* const Qs = fs;  // the item's tiles: q, k, v (and dO) from here
    __syncthreads();  // the previous item's reads of shared memory are done
    load(item, Qs);
    commit();
    wait_group<0>();
"""
K9_F32_TWO_STAGES = """  if (blockIdx.x < items) load(blockIdx.x, fs);
  commit();
  for (long long item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
    float* const Qs = fs + (it & 1) * stage;
    __syncthreads();  // the previous item's reads of shared memory are done
    if (item + gridDim.x < items) load(item + gridDim.x, fs + (~it & 1) * stage);
    commit();
    wait_group<1>();
"""
K9_F32_VARIANTS = {
    "kernel": [],
    "two stages": [(K9_F32_ONE_STAGE, K9_F32_TWO_STAGES, 2),
                   ("i < stage; i += blockDim.x) fs[i] = 0.0f;",
                    "i < 2 * stage; i += blockDim.x) fs[i] = 0.0f;"),
                   ("sizeof(float) * 3 * tile_rows<R>(a.n) * a.ld;",
                    "sizeof(float) * 6 * tile_rows<R>(a.n) * a.ld;"),
                   ("float* Sb = fs + stage;", "float* Sb = fs + 2 * stage;"),
                   ("return 4 * static_cast<size_t>(a.nr) * a.ld",
                    "return 8 * static_cast<size_t>(a.nr) * a.ld")],
    "one row a thread": [("launch<32, 2, VEC>(a, threads", "launch<32, 1, VEC>(a, threads"),
                         ("launch<64, 2, VEC>(a, threads", "launch<64, 1, VEC>(a, threads")],
    "no loads": [(K9_F32_LOAD, K9_F32_LOAD + "    if (a.n > 0) return;\n", 2)],
    "no exponentials": [("s[r][j] = expf(__fsub_rn(s[r][j], m));", "s[r][j] = __fsub_rn(s[r][j], m);"),
                        ("ev[e] = expf(__fsub_rn(f4(x, e), m));", "ev[e] = __fsub_rn(f4(x, e), m);")],
    "no products": [("  for (int c = 0; c < a.dp; c += 4) {",
                     "  for (int c = 0; c < (a.n < 0 ? a.dp : 0); c += 4) {", 2),
                    ("    for (int d = 0; d < a.dp; d += 4) {",
                     "    for (int d = 0; d < (a.n < 0 ? a.dp : 0); d += 4) {"),
                    ("        for (int i = 0; i < rows; ++i) {",
                     "        for (int i = 0; i < (a.n < 0 ? rows : 0); ++i) {"),
                    ("        for (int j = 0; j < a.np; j += 4) {",
                     "        for (int j = 0; j < (a.n < 0 ? a.np : 0); j += 4) {")],
    "no S/dP products": [("    for (int d = 0; d < a.dp; d += 4) {",
                          "    for (int d = 0; d < (a.n < 0 ? a.dp : 0); d += 4) {")],
    "no stores": [("    write_rows<VEC>(a.o + at.b", "    if (a.n < 0) write_rows<VEC>(a.o + at.b"),
                  ("if (hh < at.nh) store_tile<VEC>(a.dq", "if (a.n < 0) store_tile<VEC>(a.dq"),
                  ("      if (hh >= at.nh) continue;", "      if (hh >= at.nh || a.n > 0) continue;")],
}
K9_F32_BWD_ONLY = ("no S/dP products",)
K9_F32_FWD_ONLY = ("one row a thread",)
K9_F32_EXACT = ("two stages", "one row a thread")
K9_F32_STAGES = ("kernel", "two stages")
K4_F32_NARROW_SHAPES = ((32, 16, 1000, 24), (1920, 16, 192, 16))
K4_F32_WIDE_SHAPES = ((16, 3, 1000, 128), (1920, 2, 192, 128), (12288, 2, 30, 128))


def _ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _build_variants(source: str, entry, variants: dict) -> dict:
    """{variant: the ctypes entry of its library (a tuple of them when
    ``entry`` is a tuple of names)}, built in parallel. A substitution is
    (text, replacement) for text found once, or (text, replacement, count)."""
    text = (_build.CSRC / source).read_text()
    out = _build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new, *count in subs:
            want = count[0] if count else 1
            if src.count(old) != want:
                raise RuntimeError(f"{source}: variant {name!r} finds {old!r} "
                                   f"{src.count(old)} times, not {want}")
            src = src.replace(old, new)
        first = entry if isinstance(entry, str) else entry[0]
        tag = f"{first}_{''.join(c if c.isalnum() else '_' for c in name)}"
        (out / f"{tag}.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o",
               str(out / f"lib{tag}.so"), str(out / f"{tag}.cu"), str(_build.CSRC / "common.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out / f"lib{tag}.so")
    entries = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} variant {name!r}:\n{log}")
        fns = []
        for each in ((entry,) if isinstance(entry, str) else entry):
            fn = getattr(ctypes.CDLL(str(lib)), each)
            fn.argtypes, fn.restype = _build.SIGNATURES[each], ctypes.c_int
            fns.append(fn)
        entries[name] = fns[0] if isinstance(entry, str) else tuple(fns)
    return entries


def _checked(fn, args):
    """A call of a ctypes entry that raises on a CUDA error code."""
    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"{fn.__name__}: CUDA error {code}")
    return call


def _in_turns(label: str, calls: dict, smi: str) -> None:
    for name in (*calls, *reversed(list(calls))):
        print(f"{label} {name}: {_ms(calls[name]):.4f} ms | {smi}", flush=True)


def _k2(gen, dev, stream, smi) -> None:
    k2 = _build_variants("fused_mlp.cu", "lam_fused_mlp_sm90", K2_VARIANTS)
    bf = torch.bfloat16
    rows, d = 1843200, 256
    x = torch.randn(rows, d, generator=gen).to(dev, bf)
    w1 = (torch.randn(3 * d + 2 * d, d, generator=gen) * 0.05).to(dev, bf)[3 * d:].t()
    b1 = (torch.randn(2 * d, generator=gen) * 0.1).to(dev, bf)
    w2 = (torch.randn(d, 3 * d, generator=gen) * 0.05).to(dev, bf)[:, d:].t()
    out = torch.empty(rows, d, dtype=torch.float32, device=dev)
    table = torch.empty(fm.GELU_TABLE_ENTRIES, dtype=torch.int16, device=dev)
    args = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            table.data_ptr(), rows, d, 2 * d, d, x.stride(0), w1.stride(1), w2.stride(1),
            out.stride(0), *fm.sm90_plan(d, d), int(fm.x_tma_ok(x)), stream)
    _in_turns(f"K2 [{rows},{d}] -> {2 * d} -> {d}",
              {name: _checked(fn, args) for name, fn in k2.items()}, smi)


def _k8(gen, dev, stream, smi) -> None:
    """K8's Hopper route at the 4AA Euler-10 B=8 shape [8000, 2, 384] at
    both head splits, and its device time from the profiler."""
    k8 = _build_variants("fused_spatial_block_sm90.cu", "lam_spatial_block_sm90", K8_VARIANTS)
    bf = torch.bfloat16
    n, l, d, m = 8000, 2, 384, 768
    x = torch.randn(n, l, d, generator=gen).to(dev, bf)
    w1 = (torch.randn(3 * d + m, d, generator=gen) * d ** -0.5).to(dev, bf)
    b1 = (torch.randn(3 * d + m, generator=gen) * 0.1).to(dev, bf)
    w2 = (torch.randn(d, d + m, generator=gen) * (d + m) ** -0.5).to(dev, bf)
    b2 = (torch.randn(d, generator=gen) * 0.1).to(dev, bf)
    out = torch.empty_like(x)
    table = torch.empty(fm.GELU_TABLE_ENTRIES, dtype=torch.int16, device=dev)
    for heads in (16, 3):
        dh = d // heads
        qs, ks = ((1 + 0.2 * torch.randn(dh, generator=gen)).to(dev) for _ in range(2))
        cos, sin = rope_cos_sin(l, dh, device=dev)
        plan = fsb.sm90_plan(n, l, d, m, heads)
        args = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), qs.data_ptr(), ks.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                table.data_ptr(), n, l, d, m, heads, w1.stride(0), w2.stride(0), dh ** -0.5,
                plan.s1, plan.s2, d, 0, stream)
        calls = {name: _checked(fn, args) for name, fn in k8.items()}
        _in_turns(f"K8 [{n},{l},{d}] {heads}x{dh}", calls, smi)
        device = cs.device_ms(calls["kernel"], "spatial_sm90_kernel", REPS)
        print(f"K8 [{n},{l},{d}] {heads}x{dh} kernel (device): {device:.4f} ms | {smi}", flush=True)


def _k8_f32(gen, dev, stream, smi) -> None:
    """K8's outer-product fp32 kernel at the 4AA eval's shapes (B=2 and B=8)
    at 16 x 24 and 3 x 128, the fp32 train step's forward [16000, 2, 384]
    at 16 x 24, and one repeat of the NBA and pedestrian fp32 test passes
    ([20480, 8, 256] at 16 x 16, [5120, 2, 128] at 4 x 32), on the w1
    stream and the contiguous w2^T copy the wrapper makes. At NBA and the
    pedestrian width the dot-product route (the first fp32 kernel, at its
    head group of 128) runs first and last in the turns, and the kernel and
    each layout variant are checked bit for bit against it."""
    k8 = _build_variants("fused_spatial_block_f32.cu",
                         ("lam_spatial_block_f32_tiled", "lam_spatial_block_f32"), K8_F32_VARIANTS)
    shapes = ((2000, 2, 384, 16), (8000, 2, 384, 16), (2000, 2, 384, 3), (8000, 2, 384, 3),
              (16000, 2, 384, 16), (20480, 8, 256, 16), (5120, 2, 128, 4))
    for n, l, d, heads in shapes:
        m, dh = 2 * d, d // heads
        w1 = (torch.randn(3 * d + m, d, generator=gen) * d ** -0.5).to(dev)
        b1 = (torch.randn(3 * d + m, generator=gen) * 0.1).to(dev)
        w2 = (torch.randn(d, d + m, generator=gen) * (d + m) ** -0.5).to(dev)
        w2t = w2.t().contiguous()
        b2 = (torch.randn(d, generator=gen) * 0.1).to(dev)
        x = torch.randn(n, l, d, generator=gen).to(dev)
        qs, ks = ((1 + 0.2 * torch.randn(dh, generator=gen)).to(dev) for _ in range(2))
        cos, sin = rope_cos_sin(l, dh, device=dev)
        plan = fsb.f32_plan(n, l, d, m, heads)
        outs, calls, streams = {}, {}, {}  # streams: head group -> its w1 stream

        def tiled_call(name, group, bm):
            out = outs[name] = torch.empty_like(x)
            if group not in streams:
                streams[group] = w1.flatten()[fsb._w1_stream_index(d, m, group, d, dev, d)]
            args = (x.data_ptr(), streams[group].data_ptr(), b1.data_ptr(), qs.data_ptr(),
                    ks.data_ptr(), w2t.data_ptr(), b2.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    out.data_ptr(), n, l, d, m, heads, dh ** -0.5, group, bm, d, 0, stream)
            return _checked(k8[name][0], args)

        if d != 384:
            out = outs["dot-product route"] = torch.empty_like(x)
            calls["dot-product route"] = _checked(k8["kernel"][1], (
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), qs.data_ptr(), ks.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), n, l,
                d, m, heads, d, d + m, dh ** -0.5, fsb.f32_group(d, heads), d, 0, stream))
        for name in k8:
            layout = K8_F32_LAYOUT.get(name, {d: None})
            if d not in layout:
                continue
            group, bm = layout[d] or (None, None)
            calls[name] = tiled_call(name, group or plan.group, bm or plan.rows)
        label = f"K8-fp32 [{n},{l},{d}] {heads}x{dh} ({plan.blocks} blocks of {plan.rows} rows)"
        if d != 384:
            for name in ("kernel", *(v for v in K8_F32_LAYOUT if d in K8_F32_LAYOUT[v])):
                calls[name]()
                calls["dot-product route"]()
                torch.cuda.synchronize()
                same = torch.equal(outs[name], outs["dot-product route"])
                print(f"{label} {name}: bit-identical to the dot-product route: {same}",
                      flush=True)
        _in_turns(label, calls, smi)
        del x, outs, calls, streams
        torch.cuda.empty_cache()


def _k1_f32_narrow(gen, dev, stream, smi) -> None:
    """K1's narrow fp32 kernel in its plan's geometry: K3-fp32 on the 4AA
    eval's packed q/k/v (16 x 24, v a view of linear1's output) at B = 2 and
    B = 8, [4, 1000, 384] and [16, 1000, 384], and on MD17's spatial axis
    [1920, 192, 256] (16 x 16); K1-fp32 on stage 1's latent self-attention
    [9600, 2, 192, 16] and, with the bias, its cross-attention [1920, 8,
    192 -> 32, 16]."""
    k1 = _build_variants("flash_attention.cu", "lam_flash_attention_fwd_f32",
                         K1_F32_NARROW_VARIANTS)
    for b, h, nq, nk, dh, masked in ((4, 16, 1000, 1000, 24, False),
                                     (16, 16, 1000, 1000, 24, False),
                                     (1920, 16, 192, 192, 16, False),
                                     (9600, 2, 192, 192, 16, False),
                                     (1920, 8, 192, 32, 16, True)):
        q = torch.randn(b, nq, h * dh, generator=gen).to(dev)
        k = torch.randn(b, nk, h * dh, generator=gen).to(dev)
        v = torch.randn(b, nk, 3 * h * dh, generator=gen).to(dev)[..., -h * dh:]
        q, k, v = (t.unflatten(-1, (h, dh)).transpose(1, 2) for t in (q, k, v))
        out = torch.empty(b, nq, h, dh, device=dev).transpose(1, 2)
        bias = None
        if masked:
            keep = torch.arange(nk)[None, :] < torch.randint(9, 22, (b, 1), generator=gen)
            bias = fa.mask_to_bias(keep.to(dev)).contiguous()
        strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
        plan = fa.f32_narrow_fwd_plan(dh, nk)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                None if bias is None else bias.data_ptr(), b, h, nq, nk, dh, *strides,
                dh ** -0.5, plan.dp, plan.keys, stream)
        names = [n for n in K1_F32_NARROW_VARIANTS if masked or "Nk <= 32" not in n]
        _in_turns(f"K1-fp32 narrow [{b},{h},{nq}->{nk},{dh}] (dp {plan.dp}, {plan.keys}-key "
                  f"tiles)", {name: _checked(k1[name], args) for name in names}, smi)
        del q, k, v, out
        torch.cuda.empty_cache()


def _k7(gen, dev, stream, smi) -> None:
    """K7 with the residual at the MD17 protocol batch's [320, 30, 192, 256]
    and the 4AA B=8 solve's [8, 1000, 2, 384], h the transposed temporal
    output, the modulation chunks of one [B, 1, 1, 6D] tensor; device times
    from the profiler."""
    k7 = _build_variants("fused_adaln.cu", "lam_adaln_fwd", K7_VARIANTS)
    bf = torch.bfloat16
    for b, t, l, d in ((320, 30, 192, 256), (8, 1000, 2, 384)):
        x = (torch.randn(b, t, l, d, generator=gen) * 3).to(dev, bf)
        h = torch.randn(b, l, t, d, generator=gen).to(dev, bf).transpose(1, 2)
        shift, scale, gate = (torch.randn(b, 1, 1, 6 * d, generator=gen) * 0.5).to(dev, bf).chunk(
            6, -1)[:3]
        x_new, y = torch.empty_like(x), torch.empty_like(x)
        dims = (ctypes.c_longlong * 10)(b * t * l, t, l, d, *h.stride()[:3], gate.stride(0),
                                        shift.stride(0), scale.stride(0))
        args = (x.data_ptr(), h.data_ptr(), gate.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                x_new.data_ptr(), y.data_ptr(), dims, 1e-6, 1, stream)
        calls = {name: _checked(fn, args) for name, fn in k7.items()}
        _in_turns(f"K7 [{b},{t},{l},{d}]", calls, smi)
        for name in ("kernel", "rows in h's order"):
            device = cs.device_ms(calls[name], "adaln_kernel", REPS)
            print(f"K7 [{b},{t},{l},{d}] {name} (device): {device:.4f} ms | {smi}", flush=True)
        del x, h, x_new, y
        torch.cuda.empty_cache()


def _k9_forward(gen, dev, stream, smi) -> None:
    k9f = _build_variants("short_attention.cu", "lam_short_attention_fwd", K9_FWD_VARIANTS)
    bf, b = torch.bfloat16, 61440
    q, k = (torch.randn(b, 30, 256, generator=gen).to(dev, bf) for _ in range(2))
    v = torch.randn(b, 30, 768, generator=gen).to(dev, bf)[..., 512:]
    o = torch.empty(b, 30, 256, dtype=bf, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, 16, 30, 16,
            tsa.fwd_heads_per_block(30, 16, 16), *(s for t in (q, k, v, o) for s in t.stride()[:2]),
            0.25, stream)
    _in_turns(f"K9 forward [{b},30,256]", {name: _checked(fn, args) for name, fn in k9f.items()},
              smi)


def _k11(gen, dev, stream, smi) -> None:
    k11 = _build_variants("short_backward.cu", "lam_short_backward", K11_VARIANTS)
    bf = torch.bfloat16
    qkv = torch.randn(1920, 192, 3, 16, 16, generator=gen).to(dev, bf)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    g = torch.randn(1920, 16, 192, 16, generator=gen).to(dev, bf)
    out, lse = fa._forward(q, k, v, 0.25, with_lse=True)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)
    grads = [torch.empty(t.shape, dtype=bf, device=dev) for t in (q, k, v)]
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, g, *grads) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in grads), 1920, 16, 192,
            192, 16, strides, 0.25, int(fa.sm90_tma_ok(q, k, v, g)), stream)
    calls = {name: _checked(fn, args) for name, fn in k11.items()}
    calls["PyTorch delta"] = lambda: (g.float() * out.float()).sum(dim=-1).contiguous()
    _in_turns("K11 [1920,16,192,16]", calls, smi)


def _k9_backward(gen, dev, stream, smi) -> None:
    k9 = _build_variants("short_attention.cu", "lam_short_attention_bwd", K9_VARIANTS)
    bf, b = torch.bfloat16, 61440
    q, k, g = (torch.randn(b, 30, 256, generator=gen).to(dev, bf) for _ in range(3))
    v = torch.randn(b, 30, 768, generator=gen).to(dev, bf)[..., 512:]
    grads = [torch.empty(b, 30, 256, dtype=bf, device=dev) for _ in range(3)]
    strides = (ctypes.c_longlong * 8)(*(s for t in (q, k, v, g) for s in t.stride()[:2]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in grads), b, 16, 30, 16, tsa.bwd_heads_per_block(30, 16, 16),
            strides, grads[0].stride(0), grads[0].stride(1), 0.25, stream)
    _in_turns(f"K9 backward [{b},30,256]", {name: _checked(fn, args) for name, fn in k9.items()},
              smi)


# K9-fp32's geometries beside each plan's, by the kernel's own library:
# forward heads an item (threads to match), backward (heads an item,
# threads)
K9_F32_FWD_HEADS = (8, 2)
K9_F32_BWD_GEOMETRIES = ((4, 128), (1, 32), (8, 256))


def _k9_f32(gen, dev, stream, smi) -> None:
    """K9-fp32's forward and backward in every variant at MD17's temporal
    axis [12288, 30, 256], 16 x dh 16 (q, k and the output gradient
    contiguous, v a view of a wider buffer), in its plan's geometry, then
    the kernel in the geometries of K9_F32_FWD_HEADS and
    K9_F32_BWD_GEOMETRIES; at [256, 127, 256], 4 x dh 64, the forward on
    one and two stages (two stages of the backward pass 227 KB there) and
    the backward. The variants of K9_F32_EXACT and the other geometries
    must give the kernel's outputs bit for bit, or the run stops."""
    libs = _build_variants("short_attention_f32.cu",
                           ("lam_short_attention_fwd_f32", "lam_short_attention_bwd_f32"),
                           K9_F32_VARIANTS)
    for b, n, heads, dh in ((12288, 30, 16, 16), (256, 127, 4, 64)):
        d = heads * dh
        q, k, g = (torch.randn(b, n, d, generator=gen).to(dev) for _ in range(3))
        v = torch.randn(b, n, 3 * d, generator=gen).to(dev)[..., 2 * d:]
        out = torch.empty(b, n, d, device=dev)
        grads = [torch.empty(b, n, d, device=dev) for _ in range(3)]
        strides = (ctypes.c_longlong * 8)(*(s for t in (q, k, v, g) for s in t.stride()[:2]))
        fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, n, dh)
        fwd_tail = (*(s for t in (q, k, v, out) for s in t.stride()[:2]), dh ** -0.5, stream)
        bwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    *(t.data_ptr() for t in grads), b, heads, n, dh)
        bwd_tail = (strides, grads[0].stride(0), grads[0].stride(1), dh ** -0.5, stream)
        md17 = n == 30
        fp, bp = tsa.f32_fwd_plan(n, dh, heads), tsa.f32_bwd_plan(n, dh, heads)

        def fwd(name, h):
            rows = 1 if name == "one row a thread" or n > 64 else 2
            threads = -(-h * -(-n // rows) // 32) * 32
            return _checked(libs[name][0], (*fwd_args, h, threads, *fwd_tail))

        def bwd(name, h, threads):
            return _checked(libs[name][1], (*bwd_args, h, threads, *bwd_tail))
        fwd_calls = {name: fwd(name, fp.heads) for name in (libs if md17 else K9_F32_STAGES)
                     if name not in K9_F32_BWD_ONLY}
        for h in K9_F32_FWD_HEADS if md17 else ():
            fwd_calls[f"{h} heads"] = fwd("kernel", h)
        bwd_calls = {name: bwd(name, bp.heads, bp.threads)
                     for name in (libs if md17 else ["kernel"]) if name not in K9_F32_FWD_ONLY}
        for h, threads in K9_F32_BWD_GEOMETRIES if md17 else ():
            bwd_calls[f"{h} heads, {threads} threads"] = bwd("kernel", h, threads)
        for calls, outs in ((fwd_calls, [out]), (bwd_calls, grads)):
            calls["kernel"]()
            want = [t.clone() for t in outs]
            for name, call in calls.items():
                if name in K9_F32_EXACT or name[0].isdigit():
                    for t in outs:
                        t.fill_(float("nan"))
                    call()
                    if not all(torch.equal(a, w) for a, w in zip(outs, want)):
                        raise RuntimeError(f"K9-fp32 [{b},{n},{d}] {name}: not the kernel's bits")
            del want
        _in_turns(f"K9-fp32 forward [{b},{n},{d}] {heads}x{dh} (plan: {fp.heads} heads, "
                  f"{fp.threads} threads)", fwd_calls, smi)
        _in_turns(f"K9-fp32 backward [{b},{n},{d}] {heads}x{dh} (plan: {bp.heads} heads, "
                  f"{bp.threads} threads)", bwd_calls, smi)
        del q, k, v, g, out, grads
        torch.cuda.empty_cache()


def _k5_k6(gen, dev, stream, smi) -> None:
    bf, b, h, n, dh = torch.bfloat16, 32, 3, 1000, 128
    qkv = (2 * torch.randn(b, n, 3, h, dh, generator=gen)).to(dev, bf)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    g = torch.randn(b, h, n, dh, generator=gen).to(dev, bf)
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=gen)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(n, dh, device=dev)
    scale = dh ** -0.5
    tr = (q, k, qs, ks, cos, sin)
    q_t, k_t = fnr.qk_normrope(*tr)
    out, lse = fnr._forward(q, k, v, qs, ks, cos, sin, scale, with_lse=True)
    dq_t, dk_t, _ = fnr._attention_backward(q_t, k_t, v, out, lse, g, scale)
    saved = (q, k, v, qs, ks, cos, sin, q_t, k_t, out, lse, g, scale)
    calls = {
        "transform": lambda: fnr.qk_normrope(*tr),
        "sm90 forward on q_t/k_t (lse)": lambda: fa._launch_sm90_forward(q_t, k_t, v, scale, True,
                                                                         fnr),
        "K5 (lse)": lambda: fnr._forward(q, k, v, qs, ks, cos, sin, scale, with_lse=True),
        "sm90 backward on q_t/k_t": lambda: fnr._attention_backward(q_t, k_t, v, out, lse, g,
                                                                     scale),
        "chain VJP (plain)": lambda: plain_vjp(fnr.pre_transform, tr,
                                               (True, True, True, True, False, False),
                                               (dq_t, dk_t)),
        "K6 as the train step runs it": lambda: fnr.chain_backward(fnr._attention_backward,
                                                                   *saved),
    }
    _in_turns(f"K5/K6 pieces [{b},{h},{n},{dh}]", calls, smi)
    device = cs.device_ms(calls["transform"], "qk_normrope_kernel", REPS)
    print(f"K5/K6 pieces [{b},{h},{n},{dh}] transform (device): {device:.4f} ms | {smi}")


def _k1_f32_wide(gen, dev, stream, smi) -> None:
    """K1's register-tiled fp32 kernel on head-major views of packed fp32
    buffers, in its plan's geometry: MD17's fp32 axes at 2 x 128 (spatial
    [1920, 2, 192, 128], temporal [12288, 2, 30, 128]) and the 4AA eval's
    temporal axis at 3 x 128 (the eval's B = 2, [4, 3, 1000, 128], and the
    sampling B = 8, [16, 3, 1000, 128])."""
    k1 = _build_variants("flash_attention.cu", "lam_flash_attention_fwd_f32",
                         K1_F32_WIDE_VARIANTS)
    for b, h, n in ((1920, 2, 192), (12288, 2, 30), (4, 3, 1000), (16, 3, 1000)):
        dh = 128
        qkv = torch.randn(b, n, 3 * h * dh, generator=gen).to(dev)
        q, k, v = (t.transpose(1, 2) for t in qkv.unflatten(-1, (3, h, dh)).unbind(2))
        out = torch.empty(b, n, h, dh, device=dev).transpose(1, 2)
        strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
        seg = fa.f32_wide_plan(n, n)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, b, h, n, n,
                dh, *strides, dh ** -0.5, seg, 0, stream)
        _in_turns(f"K1-fp32 [{b},{h},{n},{dh}] {seg} sequence(s) a block",
                  {name: _checked(fn, args) for name, fn in k1.items()}, smi)
        del qkv, q, k, v, out
        torch.cuda.empty_cache()


def _k2_f32(gen, dev, stream, smi) -> None:
    """K2's outer-product fp32 kernel at the MD17 test pass's [368640, 256]
    -> 512 -> 256, the 4AA eval's [4000, 384] -> 768 -> 384 and sampling
    [16000, 384], and the pedestrian test pass's [10240, 128] -> 256 -> 128,
    on the contiguous w1^T / w2^T copies the wrapper makes, in its plan's
    row block (a layout variant in its own, K2_F32_LAYOUT); where the width
    has another instance, also the kernel in the other row block. At the
    pedestrian width the dot-product route runs first and last in the
    turns, the kernel is checked bit for bit against it, and the dot-product
    route, the kernel and its 64-row layout are also timed by their device
    time from the profiler, their calls being shorter than 0.1 ms."""
    k2 = _build_variants("fused_mlp_f32.cu", ("lam_fused_mlp_f32_tiled", "lam_fused_mlp_f32"),
                         K2_F32_VARIANTS)
    for rows, d in ((368640, 256), (4000, 384), (16000, 384), (10240, 128)):
        m = 2 * d
        x = torch.randn(rows, d, generator=gen).to(dev)
        w1t = (torch.randn(d, m, generator=gen) * d ** -0.5).to(dev)
        b1 = (torch.randn(m, generator=gen) * 0.1).to(dev)
        w2t = (torch.randn(m, d, generator=gen) * m ** -0.5).to(dev)
        out = torch.empty(rows, d, device=dev)
        bm = fm.tiled_plan(d, m, d, rows)[0]
        args = (x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), out.data_ptr(),
                rows, d, m, d, x.stride(0), out.stride(0))
        calls = {}
        if d == 128:
            w1r, w2r, dot = w1t.t().contiguous(), w2t.t().contiguous(), torch.empty_like(out)
            calls["dot-product route"] = _checked(k2["kernel"][1], (
                x.data_ptr(), w1r.data_ptr(), b1.data_ptr(), w2r.data_ptr(), dot.data_ptr(),
                rows, d, m, d, x.stride(0), d, m, dot.stride(0), *fm.f32_plan(d, d), stream))
        for name, fn in k2.items():
            layout = K2_F32_LAYOUT.get(name, {d: bm})
            if d in layout:
                calls[name] = _checked(fn[0], (*args, layout[d], stream))
        for other in sorted(o for (w, o) in fm.TILED_INSTANCES if w == d and o != bm):
            calls[f"kernel at {other} rows a block"] = _checked(k2["kernel"][0],
                                                                (*args, other, stream))
        label = f"K2-fp32 [{rows},{d}] -> {m} -> {d} ({bm} rows a block)"
        if d == 128:
            calls["kernel"]()
            calls["dot-product route"]()
            torch.cuda.synchronize()
            print(f"{label} kernel: bit-identical to the dot-product route: "
                  f"{torch.equal(out, dot)}", flush=True)
        _in_turns(label, calls, smi)
        if d == 128:
            for name in ("dot-product route", "kernel", *(c for c in calls if "64-row" in c),
                         "kernel", "dot-product route"):
                kernel = "mlp_f32_kernel" if name.startswith("dot") else "mlp_f32_tiled_kernel"
                print(f"{label} {name} (device): "
                      f"{cs.device_ms(calls[name], kernel, REPS):.4f} ms | {smi}", flush=True)
        del x, out, calls
        torch.cuda.empty_cache()


def _k4_f32_inputs(gen, dev, b, h, n, dh):
    """fp32 q/k/v head-major views of one packed buffer, a contiguous g, K1's
    out and lse, delta, empty grads in packed memory, the 21 strides."""
    qkv = torch.randn(b, n, 3 * h * dh, generator=gen).to(dev)
    q, k, v = (t.transpose(1, 2) for t in qkv.unflatten(-1, (3, h, dh)).unbind(2))
    g = torch.randn(b, h, n, dh, generator=gen).to(dev)
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True)
    delta = (g * out).sum(dim=-1).contiguous()
    grads = [torch.empty(b, n, h, dh, device=dev).transpose(1, 2) for _ in range(3)]
    strides = (ctypes.c_longlong * 21)(*(s for t in (q, k, v, g, *grads) for s in t.stride()[:3]))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None, *(t.data_ptr() for t in grads))
    return (q, k, v, g, out, lse, delta, grads), ptrs, strides


def _k4_f32(gen, dev, stream, smi) -> None:
    """K4's fp32 kernels with TF32 off, in every variant: the narrow kernel
    at the 4AA fp32 step's [32, 16, 1000, 24] and the MD17 fp32 DiT's
    [1920, 16, 192, 16], the wide kernel at the 4AA [16, 3, 1000, 128] and
    MD17's [1920, 2, 192, 128] and [12288, 2, 30, 128] (there one key tile
    holds every key: no dQ shares to sum)."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    libs = _build_variants("flash_attention_bwd.cu", "lam_flash_attention_bwd_f32",
                           K4_F32_VARIANTS)
    for b, h, n, dh in (*K4_F32_NARROW_SHAPES, *K4_F32_WIDE_SHAPES):
        keep, ptrs, strides = _k4_f32_inputs(gen, dev, b, h, n, dh)
        wide = dh > 64
        plan = fa.f32_wide_plan(n, n) if wide else fa.f32_narrow_plan(dh, n, n).dp
        tiles = fa.f32_dq_tiles(dh, n, n)
        scratch = torch.empty(tiles, b * h, n, dh, device=dev) if tiles > 1 else None
        args = (*ptrs, None if scratch is None else scratch.data_ptr(), b, h, n, n, dh, strides,
                dh ** -0.5, plan, stream)
        names = (("kernel", "without dQ shares", "without their sum") if wide
                 else tuple(K4_F32_VARIANTS))
        calls = {name: _checked(libs[name], args) for name in names
                 if scratch is not None or name != "without their sum"}
        _in_turns(f"K4-fp32 {'wide' if wide else 'narrow'} [{b},{h},{n},{dh}] (plan {plan}, "
                  f"{tiles} key tile(s) of dQ shares)", calls, smi)
        del keep, scratch
        torch.cuda.empty_cache()


KERNELS = {"K4-fp32": _k4_f32, "K1-fp32-narrow": _k1_f32_narrow, "K1-fp32-wide": _k1_f32_wide,
           "K2-fp32": _k2_f32, "K2": _k2,
           "K9-forward": _k9_forward, "K11": _k11, "K9-backward": _k9_backward,
           "K9-fp32": _k9_f32, "K5-K6": _k5_k6,
           "K8": _k8, "K8-fp32": _k8_f32, "K7": _k7}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kernels", nargs="*", metavar="kernel",
                        help=f"the kernels whose variants to time, of {', '.join(KERNELS)} "
                             f"(default: all)")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    names = parser.parse_args().kernels or list(KERNELS)
    unknown = sorted(set(names) - set(KERNELS))
    if unknown:
        parser.error(f"unknown kernels {unknown}")
    for name in names:
        KERNELS[name](torch.Generator().manual_seed(0), dev, stream, smi)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
