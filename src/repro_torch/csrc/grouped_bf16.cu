// B5, the grouped (MoE) GEMM, for bf16 inputs: the half of grouped.cu's
// instantiations that compiles beside it (see grouped.cu for the design).

#include "grouped.cuh"

extern "C" int sk_grouped_gemm_bf16(int out_dt, int sm, int sk_form, const void* a,
                                    const void* b, void* c, const void* tab, void* ws,
                                    void* counters, int m, int n, int k, int bm, int bn, int bk,
                                    int nt, int n_tiles, int ipt, int ipw, int grid, int aligned,
                                    const void* bias, const void* operand, int act, int binary,
                                    void* stream) {
  return grouped_entry<__nv_bfloat16>(out_dt, sm, sk_form, a, b, c, tab, ws, counters, m, n, k,
                                      bm, bn, bk, nt, n_tiles, ipt, ipw, grid, aligned, bias,
                                      operand, act, binary, stream);
}
