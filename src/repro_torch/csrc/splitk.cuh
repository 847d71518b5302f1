// B6: the fixed-factor split-K GEMM's partials for NVIDIA Hopper (sm_90a).
//
//   splitk_kernel  <- src/repro/kernels/splitk/splitk_gemm.py:_splitk_kernel
//
// The strategy that Stream-K generalises (§2 of the paper): K is cut into s
// splits of kps = ceil(ceil(K / bk) / s) k-steps each, and split sp of
// output tile t holds the f32 partial
//
//   partials[sp, tile rows, tile cols] = A[rows, k in split sp] @ B[k in split sp, cols]
//
// with split sp covering k in [sp * kps * bk, (sp + 1) * kps * bk) ∩ [0, K),
// the TPU version's boundaries (it pads K up to bk * s; here the loads mask
// K instead). A split whose range is empty (K < bk * s) writes zeros, as the
// TPU's padded split does. The caller reduces over s and applies the
// dequant scales once, after the sum (kernels/splitk/ops.py): this kernel
// has no epilogue.
//
// Grid (x, s): block (x, sp) strides over tiles x, x + gridDim.x, ... for
// split sp, so each (tile, split) partial is written by exactly one block
// and the result is bit-identical run to run (no atomics). The TPU's grid
// ran the k-steps of a (tile, split) in order with one VMEM accumulator;
// here mac_subblock's K loop over [kbeg, kend) takes that place, through
// the cp.async ring of sk_common.cuh. Its MAC covers every operand pair:
// f32 FMA for the float pairs and float x int8/int4; for int8 activations
// (x int8 or x packed int4) an int32 MAC added into the f32 sum at each bk
// step, which starts on a bk boundary because kbeg = sp * kps * bk.
//
// What bounds it on the H100: at the decode shapes (M = 4 against a 4096 x
// 14336 weight) it reads B once and writes s * M * N f32 partials, both far
// below the card's 295 operations per byte: bound by bytes. Split-K buys
// parallelism where N / bn gives fewer tiles than the 132 SMs; the extra
// bytes are the partials, s * M * N * 4, small beside B at decode. SIMT FMA,
// no TF32; TMA and wgmma come in later work.

#pragma once

#include "sk_common.cuh"

namespace {

template <typename TA, typename TB, bool P4, int SM>
__global__ void __launch_bounds__(kThreads)
    splitk_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                  float* __restrict__ partials, int m, int n, int k, int bm, int bn, int bk,
                  int n_tiles_n, int n_total, int kps, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* smem = reinterpret_cast<TA*>(smem_raw);
  constexpr int TM = SM / 8;
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
  const int sp = blockIdx.y;
  // the split's K range; an empty one (past K) multiplies nothing and
  // writes zeros
  const int64_t span = (int64_t)kps * bk;
  const int kbeg = (int)min((int64_t)k, sp * span);
  const int kend = (int)min((int64_t)k, (sp + 1) * span);
  float* out = partials + (int64_t)sp * m * n;
  float acc[TM][4];
  for (int t = blockIdx.x; t < n_total; t += gridDim.x) {
    const int tile_m = t / n_tiles_n;
    const int tile_n = t % n_tiles_n;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = tile_m * bm + sm0;
      if (row0 >= m) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = tile_n * bn + sn0;
        if (col0 >= n) break;
        mac_subblock<TA, TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, bk, aligned, acc,
                                     smem);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int64_t row = row0 + tm * TM + i;
          if (row >= m) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = col0 + tn * 4 + j;
            if (col < n) out[row * n + col] = acc[i][j];
          }
        }
      }
    }
  }
}

// B6 for one operand pair: grid blocks over the tiles, s splits.
template <typename TA, typename TB, bool P4>
int splitk_entry(int sm, const void* a, const void* b, void* partials, int m, int n, int k,
                 int bm, int bn, int bk, int n_tiles_n, int n_total, int kps, int s, int grid,
                 int aligned, void* stream) {
  const TA* ap = static_cast<const TA*>(a);
  const TB* bp = static_cast<const TB*>(b);
  float* p = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
  const dim3 blocks(grid, s);
#define SK_SPLITK(S)                                                                           \
  return launch<splitk_kernel<TA, TB, P4, S>>(smem_bytes<TA, TB, P4, S>(), blocks, st, ap, bp, \
                                              p, m, n, k, bm, bn, bk, n_tiles_n, n_total, kps, \
                                              al)
  switch (sm) {
    case 8: SK_SPLITK(8);
    case 16: SK_SPLITK(16);
    case 32: SK_SPLITK(32);
    case 64: SK_SPLITK(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SK_SPLITK
}

}  // namespace
