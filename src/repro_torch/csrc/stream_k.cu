// Stream-K++ GEMM kernels for NVIDIA Hopper (sm_90a).
//
// Three kernels compose one GEMM under a Stream-K++ policy, exactly as the
// JAX package's Pallas kernels do on the TPU:
//
//   B1  dp_kernel       <- src/repro/kernels/dp/dp_gemm.py:_dp_kernel
//       g persistent blocks stride over the output tiles
//       [tile_offset, m_tiles * n_tiles) and write epilogue(A @ B) into C.
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
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include "quant.cuh"
#include "stream_k.cuh"

SK_QUANT_DECLARE(f32_i8)
SK_QUANT_DECLARE(bf16_i8)
SK_QUANT_DECLARE(i8_i8)
SK_QUANT_DECLARE(f32_i4)
SK_QUANT_DECLARE(bf16_i4)

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

}  // extern "C"
