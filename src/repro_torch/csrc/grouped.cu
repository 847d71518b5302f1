// B5: the one-launch ragged grouped (MoE) GEMM for NVIDIA Hopper (sm_90a).
//
// c[i] = epilogue(a[i] @ b[i]) for every group i of a (G, M, K) @ (G, K, N)
// product, where only the first sizes[i] rows of group i take part and the
// rest of C is left alone (the wrapper zeroes it when a group is short).
// Like the TPU version, ONE launch covers every group: the groups' row-blocks
// (ceil(sizes[i] / bm) each, so ragged groups never share a tile) are
// concatenated into R row-blocks, and the T = R * nt output tiles form one
// tile space. Two kernels, one per launch form:
//
//   grouped_sk_kernel <- src/repro/kernels/streamk/grouped.py:_sk_kernel
//       Stream-K form (ALL_SK, and every HYBRID, which runs as ALL_SK):
//       block x walks the flattened MAC iterations
//       [x * ipw, min((x + 1) * ipw, total)) of the T * ipt in the space.
//   grouped_dp_kernel <- src/repro/kernels/streamk/grouped.py:_dp_kernel
//       DP form: g persistent blocks stride over the T tiles.
//
// The TPU runs the Stream-K grid strictly in order and carries a split
// tile's sum in one VMEM accumulator from one workgroup to the next. CUDA
// blocks run concurrently, in no order and not all resident at once (264
// blocks need not fit), so the carry becomes a hand-off without any
// spin-wait: a segment that covers its whole tile is flushed straight into
// C; a segment of a split tile stores its f32 partial in its own workspace
// slot, fences, and bumps the tile's arrival counter. The block that arrives
// last sums the tile's slots in ascending workgroup order, applies the
// epilogue, writes C and resets the counter for the next launch. The sum
// order is fixed, so the result is bit-identical run to run. That tail is
// fix_up_split_tile of sk_common.cuh, which B2 (stream_k.cuh) runs too.
//
// Workspace: a split tile has contributors first_wg..last_wg; contributor x
// keeps its segment in slot 2x (when its range starts inside the tile) or
// 2x + 1 (when the tile is the last of a range that began earlier), so the
// workspace is (g, 2, bm, bn) f32 whatever T is. A split tile contains the
// boundary (first_wg + 1) * ipw, which no other tile contains, so first_wg
// indexes its counter: g int32 counters.
//
// No copies: group i's operands are reached through its base pointers
// (a + i*M*K, b + i*K*N, c + i*M*N; bias (G, N) and operand (G, M, N) the
// same way), and rows at or past sizes[i] are masked by the loads. The host
// builds the row-block table (group, first row, end row) once per
// (sizes, bm) and keeps its device copy.
//
// What bounds it on the H100: at the MoE decode shapes (64 experts x 4 rows
// against 2048 x 1024 weights) it reads every expert's weights once, 268 MB
// per call in bf16 (134 MB int8, 67 MB packed int4), for 8 operations per
// weight (4 rows): bound by bytes, far below the card's 295 operations per byte
// (0.0806 / 0.0406 / 0.0206 ms at 3.35 TB/s). With bf16 activations (the
// dense, int8 and int4 rungs) each sub-block runs the tensor-core mainloop of mma_bf16.cuh:
// mma.sync fed by ldmatrix, each weight read from shared memory and widened
// once per block, 16 KB chunks with 64 KB of B in flight. bf16 streams at
// 2.7 TB/s (0.098 ms, 82 % of the bound); int8 and int4 take 0.084 and
// 0.066 ms, bound not by bytes but by the passes of the loop (a
// barrier, the widening and the MMAs per 16 KB chunk). With int8
// activations (int8 or packed int4 weights) each sub-block runs the s8
// tensor-core mainloop of mma_s8.cuh: mma.sync.m16n8k32 with exact int32
// sums per bk step, each weight read from shared memory once per block and
// transposed (int4: sign-extended) into a column-major strip by byte
// permutes, each bk step's int32 sum entering the f32 sum in k order. int8
// x int8 takes 0.066 ms and int8 x int4 0.054; the Stream-K form at
// 64x16x1024x2048 0.084 and 0.072. With f32 activations (f32, int8 or
// packed int4 weights) both forms run the f32 FMA mainloop of fma_f32.cuh
// (no TF32; each weight read from shared memory and widened once per
// block): the DP form takes 0.181 / 0.078 / 0.064 ms (PERF.md has the
// Stream-K form's times). (Device times on an H100 80GB HBM3 at 700 W,
// kernel_ab.py, DP form at 64x4x1024x2048, g = 132.)
//
// The kernels are in grouped.cuh; this file instantiates them for f32
// inputs, grouped_bf16.cu for bf16 inputs and quant_*.cu for the pairs of
// the quantization ladder (see quant.cuh): there the expert weights are
// int8 (G, K, N) or packed int4 (G, ceil(K/2), N), the per-expert dequant
// scales (G, N) and, with int8 activations, the per-row scales (G, M) are
// picked by each row-block's group, as blk_group does on the TPU, and
// applied in the epilogue. The extern "C" entry launches on the caller's
// stream and returns cudaGetLastError(), which the Python wrapper checks.

#include "quant.cuh"

SK_QUANT_DECLARE(f32_i8)
SK_QUANT_DECLARE(bf16_i8)
SK_QUANT_DECLARE(i8_i8)
SK_QUANT_DECLARE(f32_i4)
SK_QUANT_DECLARE(bf16_i4)
SK_QUANT_DECLARE(i8_i4)

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = packed int4 (B only).
extern "C" {

int sk_grouped_gemm_bf16(SK_QUANT_GROUPED_PARAMS);  // grouped_bf16.cu

int sk_grouped_gemm(int a_dt, int b_dt, int out_dt, int sm, int sk_form, const void* a,
                    const void* b, void* c, const void* tab, void* ws, void* counters, int m,
                    int n, int k, int bm, int bn, int bk, int nt, int n_tiles, int ipt, int ipw,
                    int grid, int aligned, const void* bias, const void* operand,
                    const void* scale, const void* scale_a, int act, int binary, void* stream) {
#define SK_GROUPED_ARGS                                                                        \
  out_dt, sm, sk_form, a, b, c, tab, ws, counters, m, n, k, bm, bn, bk, nt, n_tiles, ipt, ipw, \
      grid, aligned, bias, operand, scale, scale_a, act, binary, stream
  if (a_dt == 0 && b_dt == 0) return grouped_entry<float, float, false>(SK_GROUPED_ARGS);
  if (a_dt == 1 && b_dt == 1) return sk_grouped_gemm_bf16(SK_GROUPED_ARGS);
  if (a_dt == 0 && b_dt == 2) return sk_grouped_gemm_f32_i8(SK_GROUPED_ARGS);
  if (a_dt == 1 && b_dt == 2) return sk_grouped_gemm_bf16_i8(SK_GROUPED_ARGS);
  if (a_dt == 2 && b_dt == 2) return sk_grouped_gemm_i8_i8(SK_GROUPED_ARGS);
  if (a_dt == 0 && b_dt == 3) return sk_grouped_gemm_f32_i4(SK_GROUPED_ARGS);
  if (a_dt == 1 && b_dt == 3) return sk_grouped_gemm_bf16_i4(SK_GROUPED_ARGS);
  if (a_dt == 2 && b_dt == 3) return sk_grouped_gemm_i8_i4(SK_GROUPED_ARGS);
  return (int)cudaErrorInvalidValue;
#undef SK_GROUPED_ARGS
}

}  // extern "C"
