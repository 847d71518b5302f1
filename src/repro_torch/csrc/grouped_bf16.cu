// B5, the grouped (MoE) GEMM, for bf16 inputs: the half of grouped.cu's
// dense instantiations that compiles beside it (see grouped.cu for the
// design).

#include "quant.cuh"

extern "C" int sk_grouped_gemm_bf16(SK_QUANT_GROUPED_PARAMS) {
  return grouped_entry<__nv_bfloat16, __nv_bfloat16, false>(
      out_dt, sm, sk_form, a, b, c, tab, ws, counters, m, n, k, bm, bn, bk, nt, n_tiles, ipt, ipw,
      grid, aligned, bias, operand, scale, scale_a, act, binary, stream);
}
