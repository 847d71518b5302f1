// B6: the fixed-factor split-K GEMM's partials for NVIDIA Hopper (sm_90a).
//
//   splitk_kernel      <- src/repro/kernels/splitk/splitk_gemm.py:_splitk_kernel
//   splitk_mma_kernel  (the same, bf16 activations)
//   splitk_s8_kernel   (the same, int8 activations)
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
// TPU's padded split does: the mainloops zero their sums and run no chunk.
// The caller reduces over s and applies the dequant scales once, after the
// sum (kernels/splitk/ops.py): these kernels have no epilogue.
//
// Grid (x, s): block (x, sp) strides over tiles x, x + gridDim.x, ... for
// split sp, so each (tile, split) partial is written by exactly one block
// and the result is bit-identical run to run (no atomics). The TPU's grid
// ran the k-steps of a (tile, split) in order with one VMEM accumulator;
// here a sub-block mainloop's K loop over [kbeg, kend) takes that place.
// Which loop depends on the activations, as for B1 (stream_k.cuh):
//
//   * bf16 (x bf16, int8 or packed int4): mma_subblock of mma_bf16.cuh,
//     mma.sync.m16n8k16 fed by ldmatrix, int8 and int4 widened to bf16 once
//     per block (splitk_mma_kernel);
//   * int8 (x int8 or packed int4): mma_s8_subblock of mma_s8.cuh,
//     mma.sync.m16n8k32, each bk step's exact int32 sum added into the f32
//     partial in the SIMT loop's order, so the partials are that loop's bit
//     for bit (splitk_s8_kernel); a split starts on a bk boundary, as that
//     loop needs, because kbeg = sp * kps * bk;
//   * f32 (x f32, int8 or int4): sk_common.cuh's SIMT mac_subblock, f32 FMA,
//     no TF32 (splitk_kernel).
//
// Each is a kernel of its own, not a compile-time branch inside
// splitk_kernel, for the reason B1's are (stream_k.cuh): such a branch moved
// the SASS of dp_kernel's SIMT instantiations.
//
// What bounds it on the H100: at the decode shapes (M = 4 against a 4096 x
// 14336 weight) it reads B once and writes s * M * N f32 partials, both far
// below the card's 295 operations per byte: bound by bytes. Split-K buys
// parallelism where N / bn gives fewer tiles than the 132 SMs; the extra
// bytes are the partials, s * M * N * 4, small beside B at decode. Against
// B1 at the same tile it runs s times the blocks, each over 1 / s of K, so
// each block fills and drains its ring s times as often per byte of B.

#pragma once

#include "mma_s8.cuh"

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

// B6 on the tensor-core mainloop, for bf16 activations: splitk_kernel's
// walk and K range, each sub-block multiplied by mma_subblock and flushed
// from its fragments into split sp's partials, masked at M and N.
template <typename TB, bool P4, int SM>
__global__ void __launch_bounds__(kThreads)
    splitk_mma_kernel(const __nv_bfloat16* __restrict__ a, const TB* __restrict__ b,
                      float* __restrict__ partials, int m, int n, int k, int bm, int bn, int bk,
                      int n_tiles_n, int n_total, int kps, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.y;
  const int64_t span = (int64_t)kps * bk;
  const int kbeg = (int)min((int64_t)k, sp * span);
  const int kend = (int)min((int64_t)k, (sp + 1) * span);
  float* out = partials + (int64_t)sp * m * n;
  for (int t = blockIdx.x; t < n_total; t += gridDim.x) {
    const int tile_m = t / n_tiles_n;
    const int tile_n = t % n_tiles_n;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = tile_m * bm + sm0;
      if (row0 >= m) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = tile_n * bn + sn0;
        if (col0 >= n) break;
        float acc[mma_mt<SM>()][2][4];
        mma_subblock<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, aligned, acc, smem_raw);
        store_subblock_mma<SM>(out, Epilogue{}, acc, m, row0, col0, n);
      }
    }
  }
}

// B6 on the s8 tensor-core mainloop, for int8 activations (int8 or packed
// int4 weights): splitk_mma_kernel's walk, each sub-block multiplied by
// mma_s8_subblock, so each split's partial is the SIMT loop's, bit for bit.
template <bool P4, int SM>
__global__ void __launch_bounds__(kThreads)
    splitk_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                     float* __restrict__ partials, int m, int n, int k, int bm, int bn, int bk,
                     int n_tiles_n, int n_total, int kps, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.y;
  const int64_t span = (int64_t)kps * bk;
  const int kbeg = (int)min((int64_t)k, sp * span);
  const int kend = (int)min((int64_t)k, (sp + 1) * span);
  float* out = partials + (int64_t)sp * m * n;
  for (int t = blockIdx.x; t < n_total; t += gridDim.x) {
    const int tile_m = t / n_tiles_n;
    const int tile_n = t % n_tiles_n;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = tile_m * bm + sm0;
      if (row0 >= m) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = tile_n * bn + sn0;
        if (col0 >= n) break;
        float acc[mma_mt<SM>()][2][4];
        mma_s8_subblock<P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, bk, aligned, acc,
                                smem_raw);
        store_subblock_mma<SM>(out, Epilogue{}, acc, m, row0, col0, n);
      }
    }
  }
}

// B6 for one operand pair: grid blocks over the tiles, s splits; the
// mainloop as launch_dp picks it (stream_k.cuh), the ring sized to match.
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
  if constexpr (uses_mma<TA>())                                                                \
    return launch<splitk_mma_kernel<TB, P4, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), blocks,  \
                                                st, ap, bp, p, m, n, k, bm, bn, bk, n_tiles_n, \
                                                n_total, kps, al);                             \
  else if constexpr (std::is_same<TA, int8_t>::value)                                          \
    return launch<splitk_s8_kernel<P4, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), blocks, st,   \
                                           ap, bp, p, m, n, k, bm, bn, bk, n_tiles_n, n_total, \
                                           kps, al);                                           \
  else                                                                                         \
    return launch<splitk_kernel<TA, TB, P4, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), blocks,  \
                                                st, ap, bp, p, m, n, k, bm, bn, bk, n_tiles_n, \
                                                n_total, kps, al)
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
