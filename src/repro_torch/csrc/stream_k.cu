// Stream-K++ GEMM kernels for NVIDIA Hopper (sm_90a).
//
// Three kernels compose one GEMM under a Stream-K++ policy, exactly as the
// JAX package's Pallas kernels do on the TPU:
//
//   B1  dp_kernel       <- src/repro/kernels/dp/dp_gemm.py:_dp_kernel
//       g persistent blocks stride over the output tiles
//       [tile_offset, m_tiles * n_tiles) and write epilogue(A @ B) into C
//       (dp_mma_kernel for bf16 activations, dp_s8_kernel for int8 ones).
//   B2  streamk_kernel  <- src/repro/kernels/streamk/streamk_gemm.py:_streamk_kernel
//       block x owns the flattened MAC-iteration range
//       [x * ipw, min((x + 1) * ipw, total)) and writes each tile segment's
//       f32 partial into partials[tile, clip(x - first_wg(tile), 0, mc - 1)].
//       The slots are disjoint, so no atomics are needed.
//   B3  fixup_kernel    <- src/repro/kernels/streamk/streamk_gemm.py:_fixup_kernel
//       one block per Stream-K tile sums slots 0..n_contrib-1 in ascending
//       order (deterministic, bit-identical run to run), applies the
//       epilogue and writes the tile straight into C at (tm, tn).
//
// The kernels are templates in stream_k.cuh; the sub-block MAC, its
// cp.async ring, the epilogue and the launch helper live in sk_common.cuh,
// which grouped.cuh (B5) shares. This file instantiates B1 and B2 for the
// dense inputs (f32 x f32, bf16 x bf16) and B3, which only reads f32
// partials; the quantization ladder's
// pairs are instantiated in quant_*.cu (see quant.cuh) and reached from the
// entries below. B2's partials stay f32 and unscaled whatever the inputs:
// the dequant scales apply once, in B3's fix-up and in B1's flush, as on
// the TPU.
//
// B6, the fixed-factor split-K baseline (splitk.cuh), sits beside them:
//
//   B6  splitk_kernel   <- src/repro/kernels/splitk/splitk_gemm.py:_splitk_kernel
//       block (x, sp) strides over the output tiles x, x + grid, ... and
//       writes split sp's f32 partial of each into partials[sp] (s, M, N);
//       the caller sums over s and applies the dequant scales
//       (splitk_mma_kernel for bf16 activations, splitk_s8_kernel for int8
//       ones).
//
// This file instantiates B6 for the dense inputs too; the pairs' B6 comes
// with their B1 and B2 from quant_*.cu.
//
// What bounds B1 and B2 on the H100: at the decode shapes (M = 4 against a
// 4096 x 14336 weight) they read B once, far below the card's 295
// operations per byte: bound by bytes (0.035 ms for bf16 at 3.35 TB/s,
// 0.018 int8, 0.009 int4). The SIMT loop of sk_common.cuh had all 8 row
// groups of a block read and widen every weight, and its int8 -> f32
// conversions made int8 slower than bf16. With bf16 activations (the dense,
// int8 and int4 rungs) each SM x 128 sub-block now runs the tensor-core
// mainloop of mma_bf16.cuh, as B5 does: mma.sync fed by ldmatrix, each
// weight read from shared memory and widened once per block, 16 KB chunks
// with 64 KB in flight. B1 at 4x14336x4096 (DP 8x128x128) then takes
// 0.044 / 0.038 / 0.034 ms on bf16 / int8 / int4 (SIMT: 0.114 / 0.177 /
// 0.133), B2 at 4x4096x14336 (ALL_SK 8x256x128) 0.045 / 0.037 / 0.028 ms
// (SIMT: 0.103 / 0.168 / 0.112); int8 and int4 are then bound by the ring's
// fill and drain per sub-block, not by bytes. With int8 activations (the
// int8-dynamic rung, and int8 x packed int4) they run the s8 tensor-core
// mainloop of mma_s8.cuh, as B5 does: mma.sync.m16n8k32 on the int8 codes,
// each bk step's exact int32 sum entering the f32 sum where the SIMT loop's
// did, so the outputs keep that loop's bits (PERF.md has the times). f32
// activations keep the SIMT FMA loop (exact f32 products, no TF32); B3
// multiplies nothing. B6 runs the mainloop B1 runs on each pair. (Device
// times on an H100 80GB HBM3 at 700 W, kernel_ab.py, g = 132.)
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

int sk_streamk_phase1(int a_dt, int b_dt, int sm, const void* a, const void* b, void* partials,
                      int m, int n, int k, int bm, int bn, int bk, int n_tiles_n, int ipt,
                      int ipw, int total, int mc, int grid, int aligned, void* stream) {
#define SK_P1_ARGS \
  sm, a, b, partials, m, n, k, bm, bn, bk, n_tiles_n, ipt, ipw, total, mc, grid, aligned, stream
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

int sk_streamk_fixup(int out_dt, const void* partials, void* c, int m, int n, int bm, int bn,
                     int n_tiles_n, int ipt, int ipw, int mc, int sk_tiles, const void* bias,
                     const void* operand, const void* scale, const void* scale_a, int act,
                     int binary, void* stream) {
  const Epilogue epi{bias, operand, static_cast<const float*>(scale),
                     static_cast<const float*>(scale_a), act, binary};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(partials);
  if (out_dt == 0)
    fixup_kernel<float><<<sk_tiles, kThreads, 0, s>>>(p, static_cast<float*>(c), m, n, bm, bn,
                                                      n_tiles_n, ipt, ipw, mc, epi);
  else if (out_dt == 1)
    fixup_kernel<__nv_bfloat16><<<sk_tiles, kThreads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(c), m, n, bm, bn, n_tiles_n, ipt, ipw, mc, epi);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
