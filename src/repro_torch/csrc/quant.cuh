// The quantization ladder's instantiations of B1, B2, B5 and B6
// (src/repro/core/quant.py; ROADMAP A8). Each quant_<pair>.cu expands
// SK_QUANT_PAIR for one (activation, weight) pair:
//
//   f32_i8, bf16_i8   int8 rung: float activations x int8 weights
//   i8_i8             int8-dynamic rung: int8 x int8, int32 MAC
//   f32_i4, bf16_i4   int4 rung: float activations x packed int4 weights
//   i8_i4             int8 activations x packed int4 weights, int32 MAC
//                     (a weight quantized with bits=4, act_bits=8)
//
// so the six compile in parallel with stream_k.cu, grouped.cu and
// grouped_bf16.cu. The pair's B1, B2 and B6 are reached from stream_k.cu's
// entries and its B5 from grouped.cu's, by dtype code; B3 is shared (it
// reads f32 partials whatever the inputs).
//
// What bounds them on the H100 is what bounds the dense kernels (see
// stream_k.cu and grouped.cu): at the serving shapes, reading B. The pairs
// read 1 (int8) or 0.5 (int4) bytes per weight in place of bf16's 2, so
// their byte bounds are a half and a quarter of the dense ones. B1, B2 and
// B5 of the i8_i8 and i8_i4 pairs run the s8 tensor cores (mma_s8.cuh): B5
// at olmoe's decode shape (DP form, 64x4x1024x2048) 0.066 and 0.054 ms
// against byte bounds of 0.040 and 0.020 ms and the SIMT loop's 0.270 and
// 0.291 ms (H100 80GB HBM3 at 700 W, kernel_ab.py); B1's and B2's times are
// in PERF.md. B6 runs the loop of B1 on every pair (splitk.cuh).

#pragma once

#include "grouped.cuh"
#include "splitk.cuh"
#include "stream_k.cuh"

#define SK_QUANT_DP_PARAMS                                                                   \
  int out_dt, int sm, const void *a, const void *b, void *c, int m, int n, int k, int bm,    \
      int bn, int bk, int n_tiles_n, int tile_offset, int n_total, int grid, int aligned,    \
      const void *bias, const void *operand, const void *scale, const void *scale_a, int act, \
      int binary, void *stream
#define SK_QUANT_P1_PARAMS                                                                 \
  int sm, const void *a, const void *b, void *partials, int m, int n, int k, int bm, int bn, \
      int bk, int n_tiles_n, int ipt, int ipw, int total, int mc, int grid, int aligned,     \
      void *stream
#define SK_QUANT_GROUPED_PARAMS                                                               \
  int out_dt, int sm, int sk_form, const void *a, const void *b, void *c, const void *tab,    \
      void *ws, void *counters, int m, int n, int k, int bm, int bn, int bk, int nt,          \
      int n_tiles, int ipt, int ipw, int grid, int aligned, const void *bias,                 \
      const void *operand, const void *scale, const void *scale_a, int act, int binary,       \
      void *stream
#define SK_QUANT_SPLITK_PARAMS                                                              \
  int sm, const void *a, const void *b, void *partials, int m, int n, int k, int bm, int bn,  \
      int bk, int n_tiles_n, int n_total, int kps, int s, int grid, int aligned, void *stream

// The four C entries of one pair, as stream_k.cu and grouped.cu call them.
#define SK_QUANT_DECLARE(tag)                                        \
  extern "C" int sk_dp_gemm_##tag(SK_QUANT_DP_PARAMS);               \
  extern "C" int sk_streamk_phase1_##tag(SK_QUANT_P1_PARAMS);        \
  extern "C" int sk_grouped_gemm_##tag(SK_QUANT_GROUPED_PARAMS);     \
  extern "C" int sk_splitk_partials_##tag(SK_QUANT_SPLITK_PARAMS);

#define SK_QUANT_PAIR(tag, TA, TB, P4)                                                          \
  SK_QUANT_DECLARE(tag)                                                                         \
  int sk_dp_gemm_##tag(SK_QUANT_DP_PARAMS) {                                                    \
    return dp_entry<TA, TB, P4>(out_dt, sm, a, b, c, m, n, k, bm, bn, bk, n_tiles_n,            \
                                tile_offset, n_total, grid, aligned, bias, operand, scale,      \
                                scale_a, act, binary, stream);                                  \
  }                                                                                             \
  int sk_streamk_phase1_##tag(SK_QUANT_P1_PARAMS) {                                             \
    return streamk_entry<TA, TB, P4>(sm, a, b, partials, m, n, k, bm, bn, bk, n_tiles_n, ipt,   \
                                     ipw, total, mc, grid, aligned, stream);                    \
  }                                                                                             \
  int sk_grouped_gemm_##tag(SK_QUANT_GROUPED_PARAMS) {                                          \
    return grouped_entry<TA, TB, P4>(out_dt, sm, sk_form, a, b, c, tab, ws, counters, m, n, k,  \
                                     bm, bn, bk, nt, n_tiles, ipt, ipw, grid, aligned, bias,    \
                                     operand, scale, scale_a, act, binary, stream);             \
  }                                                                                             \
  int sk_splitk_partials_##tag(SK_QUANT_SPLITK_PARAMS) {                                        \
    return splitk_entry<TA, TB, P4>(sm, a, b, partials, m, n, k, bm, bn, bk, n_tiles_n, n_total, \
                                    kps, s, grid, aligned, stream);                             \
  }
