// Stream-K++ GEMM kernels for NVIDIA Hopper (sm_90a).
//
// Two kernels compose one GEMM under a Stream-K++ policy, where the JAX
// package's Pallas kernels on the TPU take three:
//
//   B1  dp_fma_kernel   <- src/repro/kernels/dp/dp_gemm.py:_dp_kernel
//       g persistent blocks stride over the output tiles
//       [tile_offset, m_tiles * n_tiles) and write epilogue(A @ B) into C
//       (dp_fma_kernel for f32 activations, dp_mma_kernel for bf16 ones,
//       dp_s8_kernel for int8 ones).
//   B2  streamk_kernel  <- src/repro/kernels/streamk/streamk_gemm.py:_streamk_kernel
//       and B3             src/repro/kernels/streamk/streamk_gemm.py:_fixup_kernel
//       block x owns the flattened MAC-iteration range
//       [x * ipw, min((x + 1) * ipw, total)). A tile it owns whole is
//       flushed from registers through the epilogue into C. A segment of a
//       split tile writes its f32 partial into its own slot
//       partials[tile, x - first_wg(tile)], then arrives at the tile's
//       counter; the last contributor to arrive sums slots 0..n_contrib-1
//       in ascending order from 0.f (deterministic, bit-identical run to
//       run, and the TPU fix-up's order), applies the epilogue and writes
//       the tile into C at (tm, tn). So the fix-up, a launch of its own on
//       the TPU, is the tail of the sweep here: no block waits on another,
//       and a Stream-K region is one launch.
//
// The kernels are templates in stream_k.cuh; the sub-block mainloops live
// in mma_bf16.cuh, mma_s8.cuh and fma_f32.cuh, the epilogue, the split-tile
// tail (fix_up_split_tile, shared with B5's Stream-K form) and the launch
// helper in sk_common.cuh, all shared with grouped.cuh (B5) and splitk.cuh.
// This file instantiates B1 and B2 for the dense inputs (f32 x f32, bf16 x
// bf16); the quantization ladder's pairs are instantiated in quant_*.cu
// (see quant.cuh) and reached from the entries below. B2's partials stay
// f32 and unscaled whatever the inputs: the dequant scales apply once, in
// the flush of a tile, as on the TPU.
//
// B6, the fixed-factor split-K baseline (splitk.cuh), sits beside them:
//
//   B6  splitk_fma_kernel <- src/repro/kernels/splitk/splitk_gemm.py:_splitk_kernel
//       block (x, sp) strides over the output tiles x, x + grid, ... and
//       writes split sp's f32 partial of each into partials[sp] (s, M, N);
//       the caller sums over s and applies the dequant scales
//       (splitk_fma_kernel for f32 activations, splitk_mma_kernel for bf16
//       ones, splitk_s8_kernel for int8 ones).
//
// This file instantiates B6 for the dense inputs too; the pairs' B6 comes
// with their B1 and B2 from quant_*.cu.
//
// What bounds B1 and B2 on the H100: at the decode shapes (M = 4 against a
// 4096 x 14336 weight) they read B once, far below the card's 295
// operations per byte: bound by bytes (0.035 ms for bf16 at 3.35 TB/s,
// 0.018 int8, 0.009 int4). With bf16 activations (the dense, int8 and int4
// rungs) each SM x 128 sub-block runs the tensor-core
// mainloop of mma_bf16.cuh, as B5 does: mma.sync fed by ldmatrix, each
// weight read from shared memory and widened once per block, 16 KB chunks
// with 64 KB in flight. B1 at 4x14336x4096 (DP 8x128x128) then takes
// 0.044 / 0.038 / 0.034 ms on bf16 / int8 / int4 (PERF.md has B2's
// times at 4x4096x14336, ALL_SK 8x256x128); int8 and int4 are bound by the ring's fill and drain per sub-block, not by
// bytes. With int8 activations (the int8-dynamic rung, and int8 x packed
// int4) they run the s8 tensor-core mainloop of mma_s8.cuh, as B5 does:
// mma.sync.m16n8k32 on the int8 codes, each bk step's exact int32 sum
// entering the f32 sum in k order (PERF.md has the times). With f32 activations (the dense f32
// pair, f32 x int8 and f32 x int4) they run the f32 FMA mainloop of
// fma_f32.cuh: exact f32 products (no TF32), each weight read from shared
// memory and widened once per block (PERF.md has the times). B6 runs the
// mainloop B1 runs on the same activations (splitk.cuh). (Device times on
// an H100 80GB HBM3 at 700 W, kernel_ab.py, g = 132.)
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include "quant.cuh"
#include "splitk.cuh"
#include "stream_k.cuh"

SK_QUANT_DECLARE(f32_i8)
SK_QUANT_DECLARE(bf16_i8)
SK_QUANT_DECLARE(i8_i8)
SK_QUANT_DECLARE(f32_i4)
SK_QUANT_DECLARE(bf16_i4)
SK_QUANT_DECLARE(i8_i4)

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = packed int4 (B only).
extern "C" {

int sk_dp_gemm(int a_dt, int b_dt, int out_dt, int sm, const void* a, const void* b, void* c,
               int m, int n, int k, int bm, int bn, int bk, int n_tiles_n, int tile_offset,
               int n_total, int grid, int aligned, const void* bias, const void* operand,
               const void* scale, const void* scale_a, int act, int binary, void* stream) {
#define SK_DP_ARGS                                                                               \
  out_dt, sm, a, b, c, m, n, k, bm, bn, bk, n_tiles_n, tile_offset, n_total, grid, aligned, bias, \
      operand, scale, scale_a, act, binary, stream
  if (a_dt == 0 && b_dt == 0) return dp_entry<float, float, false>(SK_DP_ARGS);
  if (a_dt == 1 && b_dt == 1) return dp_entry<__nv_bfloat16, __nv_bfloat16, false>(SK_DP_ARGS);
  if (a_dt == 0 && b_dt == 2) return sk_dp_gemm_f32_i8(SK_DP_ARGS);
  if (a_dt == 1 && b_dt == 2) return sk_dp_gemm_bf16_i8(SK_DP_ARGS);
  if (a_dt == 2 && b_dt == 2) return sk_dp_gemm_i8_i8(SK_DP_ARGS);
  if (a_dt == 0 && b_dt == 3) return sk_dp_gemm_f32_i4(SK_DP_ARGS);
  if (a_dt == 1 && b_dt == 3) return sk_dp_gemm_bf16_i4(SK_DP_ARGS);
  if (a_dt == 2 && b_dt == 3) return sk_dp_gemm_i8_i4(SK_DP_ARGS);
  return (int)cudaErrorInvalidValue;
#undef SK_DP_ARGS
}

int sk_streamk_phase1(int a_dt, int b_dt, int out_dt, int sm, const void* a, const void* b,
                      void* c, void* partials, void* counters, int m, int n, int k, int bm,
                      int bn, int bk, int n_tiles_n, int ipt, int ipw, int total, int mc,
                      int grid, int aligned, const void* bias, const void* operand,
                      const void* scale, const void* scale_a, int act, int binary,
                      void* stream) {
#define SK_P1_ARGS                                                                          \
  out_dt, sm, a, b, c, partials, counters, m, n, k, bm, bn, bk, n_tiles_n, ipt, ipw, total, mc, \
      grid, aligned, bias, operand, scale, scale_a, act, binary, stream
  if (a_dt == 0 && b_dt == 0) return streamk_entry<float, float, false>(SK_P1_ARGS);
  if (a_dt == 1 && b_dt == 1)
    return streamk_entry<__nv_bfloat16, __nv_bfloat16, false>(SK_P1_ARGS);
  if (a_dt == 0 && b_dt == 2) return sk_streamk_phase1_f32_i8(SK_P1_ARGS);
  if (a_dt == 1 && b_dt == 2) return sk_streamk_phase1_bf16_i8(SK_P1_ARGS);
  if (a_dt == 2 && b_dt == 2) return sk_streamk_phase1_i8_i8(SK_P1_ARGS);
  if (a_dt == 0 && b_dt == 3) return sk_streamk_phase1_f32_i4(SK_P1_ARGS);
  if (a_dt == 1 && b_dt == 3) return sk_streamk_phase1_bf16_i4(SK_P1_ARGS);
  if (a_dt == 2 && b_dt == 3) return sk_streamk_phase1_i8_i4(SK_P1_ARGS);
  return (int)cudaErrorInvalidValue;
#undef SK_P1_ARGS
}

int sk_splitk_partials(int a_dt, int b_dt, int sm, const void* a, const void* b,
                       void* partials, int m, int n, int k, int bm, int bn, int bk,
                       int n_tiles_n, int n_total, int kps, int s, int grid, int aligned,
                       void* stream) {
#define SK_SPLITK_ARGS \
  sm, a, b, partials, m, n, k, bm, bn, bk, n_tiles_n, n_total, kps, s, grid, aligned, stream
  if (a_dt == 0 && b_dt == 0) return splitk_entry<float, float, false>(SK_SPLITK_ARGS);
  if (a_dt == 1 && b_dt == 1)
    return splitk_entry<__nv_bfloat16, __nv_bfloat16, false>(SK_SPLITK_ARGS);
  if (a_dt == 0 && b_dt == 2) return sk_splitk_partials_f32_i8(SK_SPLITK_ARGS);
  if (a_dt == 1 && b_dt == 2) return sk_splitk_partials_bf16_i8(SK_SPLITK_ARGS);
  if (a_dt == 2 && b_dt == 2) return sk_splitk_partials_i8_i8(SK_SPLITK_ARGS);
  if (a_dt == 0 && b_dt == 3) return sk_splitk_partials_f32_i4(SK_SPLITK_ARGS);
  if (a_dt == 1 && b_dt == 3) return sk_splitk_partials_bf16_i4(SK_SPLITK_ARGS);
  if (a_dt == 2 && b_dt == 3) return sk_splitk_partials_i8_i4(SK_SPLITK_ARGS);
  return (int)cudaErrorInvalidValue;
#undef SK_SPLITK_ARGS
}

}  // extern "C"
