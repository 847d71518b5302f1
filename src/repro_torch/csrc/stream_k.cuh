// B1-B3's kernels, templated on the operand types: see stream_k.cu for the
// design. stream_k.cu instantiates them for the dense f32 and bf16 inputs,
// and each quant_*.cu for one pair of the quantization ladder, so the
// sources compile in parallel. With bf16 activations (the dense bf16, int8
// and int4 rungs) each sub-block of B1 and B2 runs the tensor-core mainloop
// of mma_bf16.cuh, with int8 activations (int8 or packed int4 weights) the
// s8 tensor-core mainloop of mma_s8.cuh; f32 activations run sk_common.cuh's
// SIMT loop. B3 multiplies nothing: it reads B2's f32 partials whatever the
// inputs.

#pragma once

#include "mma_bf16.cuh"
#include "mma_s8.cuh"
#include "sk_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B1: data-parallel region
// ---------------------------------------------------------------------------

template <typename TA, typename TB, bool P4, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads)
    dp_kernel(const TA* __restrict__ a, const TB* __restrict__ b, TOut* __restrict__ c, int m,
              int n, int k, int bm, int bn, int bk, int n_tiles_n, int tile_offset, int n_total,
              bool aligned, Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* smem = reinterpret_cast<TA*>(smem_raw);
  constexpr int TM = SM / 8;
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
  float acc[TM][4];
  for (int t = tile_offset + blockIdx.x; t < n_total; t += gridDim.x) {
    const int tile_m = t / n_tiles_n;
    const int tile_n = t % n_tiles_n;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = tile_m * bm + sm0;
      if (row0 >= m) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = tile_n * bn + sn0;
        if (col0 >= n) break;
        mac_subblock<TA, TB, P4, SM>(a, b, m, n, k, row0, col0, 0, k, bk, aligned, acc, smem);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int64_t row = row0 + tm * TM + i;
          if (row >= m) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = col0 + tn * 4 + j;
            if (col < n)
              c[row * n + col] = from_f32<TOut>(apply_epilogue<TOut>(acc[i][j], epi, row, col, n));
          }
        }
      }
    }
  }
}

// B1 on the tensor-core mainloop, for bf16 activations: dp_kernel's walk
// over the tiles, each sub-block multiplied by mma_subblock and flushed from
// its fragments. A kernel of its own and not a compile-time branch inside
// dp_kernel: such a branch changed the SASS of dp_kernel's SIMT
// instantiations (int8 x int8 at SM = 8 ran 2.5 % slower on the H100),
// which keep the code they had.
template <typename TB, bool P4, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads)
    dp_mma_kernel(const __nv_bfloat16* __restrict__ a, const TB* __restrict__ b,
                  TOut* __restrict__ c, int m, int n, int k, int bm, int bn, int n_tiles_n,
                  int tile_offset, int n_total, bool aligned, Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (int t = tile_offset + blockIdx.x; t < n_total; t += gridDim.x) {
    const int tile_m = t / n_tiles_n;
    const int tile_n = t % n_tiles_n;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = tile_m * bm + sm0;
      if (row0 >= m) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = tile_n * bn + sn0;
        if (col0 >= n) break;
        float acc[mma_mt<SM>()][2][4];
        mma_subblock<TB, P4, SM>(a, b, m, n, k, row0, col0, 0, k, aligned, acc, smem_raw);
        store_subblock_mma<SM>(c, epi, acc, m, row0, col0, n);
      }
    }
  }
}

// B1 on the s8 tensor-core mainloop, for int8 activations (int8 or packed
// int4 weights): dp_mma_kernel's walk, each sub-block multiplied by
// mma_s8_subblock, which adds each bk step's exact int32 sum into the f32
// accumulator where dp_kernel's SIMT loop did (so C is that loop's, bit for
// bit), and flushed from its fragments. A kernel of its own for the reason
// dp_mma_kernel is one.
template <bool P4, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads)
    dp_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 TOut* __restrict__ c, int m, int n, int k, int bm, int bn, int bk, int n_tiles_n,
                 int tile_offset, int n_total, bool aligned, Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (int t = tile_offset + blockIdx.x; t < n_total; t += gridDim.x) {
    const int tile_m = t / n_tiles_n;
    const int tile_n = t % n_tiles_n;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = tile_m * bm + sm0;
      if (row0 >= m) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = tile_n * bn + sn0;
        if (col0 >= n) break;
        float acc[mma_mt<SM>()][2][4];
        mma_s8_subblock<P4, SM>(a, b, m, n, k, row0, col0, 0, k, bk, aligned, acc, smem_raw);
        store_subblock_mma<SM>(c, epi, acc, m, row0, col0, n);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B2: the Stream-K sweep
// ---------------------------------------------------------------------------

template <typename TA, typename TB, bool P4, int SM>
__global__ void __launch_bounds__(kThreads)
    streamk_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                   float* __restrict__ partials, int m, int n, int k, int bm, int bn, int bk,
                   int n_tiles_n, int ipt, int ipw, int total, int mc, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* smem = reinterpret_cast<TA*>(smem_raw);
  constexpr int TM = SM / 8;
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
  const int x = blockIdx.x;
  const int64_t start = (int64_t)x * ipw;
  if (start >= total) return;
  const int end = (int)min((int64_t)total, start + ipw);
  float acc[TM][4];  // the SIMT loop's; the mma loops keep their fragments in frag
  int it = (int)start;
  while (it < end) {
    const int tile = it / ipt;
    const int seg_end = min(end, (tile + 1) * ipt);
    const int kbeg = (it - tile * ipt) * bk;
    const int kend = min((seg_end - tile * ipt) * bk, k);
    const int first_wg = (tile * ipt) / ipw;
    const int slot = min(max(x - first_wg, 0), mc - 1);
    float* out = partials + ((int64_t)tile * (mc + 1) + slot) * bm * bn;
    const int tile_m = tile / n_tiles_n;
    const int tile_n = tile % n_tiles_n;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int row0 = tile_m * bm + sm0;
        const int col0 = tile_n * bn + sn0;
        if constexpr (uses_mma<TA>()) {
          float frag[mma_mt<SM>()][2][4];
          mma_subblock<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, aligned, frag,
                                   smem_raw);
          park_subblock_mma<SM>(frag, out + (int64_t)sm0 * bn + sn0, bn);
        } else if constexpr (std::is_same<TA, int8_t>::value) {
          float frag[mma_mt<SM>()][2][4];
          mma_s8_subblock<P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, bk, aligned, frag,
                                  smem_raw);
          park_subblock_mma<SM>(frag, out + (int64_t)sm0 * bn + sn0, bn);
        } else {
          mac_subblock<TA, TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, bk, aligned, acc,
                                       smem);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            float* dst = out + (int64_t)(sm0 + tm * TM + i) * bn + sn0 + tn * 4;
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          }
        }
      }
    }
    it = seg_end;
  }
}

// ---------------------------------------------------------------------------
// B3: deterministic fix-up
// ---------------------------------------------------------------------------

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    fixup_kernel(const float* __restrict__ partials, TOut* __restrict__ c, int m, int n, int bm,
                 int bn, int n_tiles_n, int ipt, int ipw, int mc, Epilogue epi) {
  const int t = blockIdx.x;
  const int first_wg = (t * ipt) / ipw;
  const int last_wg = ((t + 1) * ipt - 1) / ipw;
  const int n_contrib = last_wg - first_wg + 1;
  const int tile_m = t / n_tiles_n;
  const int tile_n = t % n_tiles_n;
  const int64_t slot_stride = (int64_t)bm * bn;
  const float* base = partials + (int64_t)t * (mc + 1) * slot_stride;
  for (int e = threadIdx.x; e < bm * bn; e += blockDim.x) {
    const int r = e / bn;
    const int cc = e % bn;
    const int64_t row = (int64_t)tile_m * bm + r;
    const int col = tile_n * bn + cc;
    if (row >= m || col >= n) continue;
    float acc = 0.f;
    for (int s = 0; s < n_contrib; ++s) acc += base[s * slot_stride + e];
    c[row * n + col] = from_f32<TOut>(apply_epilogue<TOut>(acc, epi, row, col, n));
  }
}

template <typename TA, typename TB, bool P4, typename TOut>
int launch_dp(int sm, const void* a, const void* b, void* c, int m, int n, int k, int bm, int bn,
              int bk, int n_tiles_n, int tile_offset, int n_total, int grid, bool aligned,
              Epilogue epi, cudaStream_t stream) {
  const TA* ap = static_cast<const TA*>(a);
  const TB* bp = static_cast<const TB*>(b);
  TOut* cp = static_cast<TOut*>(c);
#define SK_DP(S)                                                                            \
  if constexpr (uses_mma<TA>())                                                                  \
    return launch<dp_mma_kernel<TB, P4, TOut, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid,    \
                                                  stream, ap, bp, cp, m, n, k, bm, bn, n_tiles_n, \
                                                  tile_offset, n_total, aligned, epi);           \
  else if constexpr (std::is_same<TA, int8_t>::value)                                            \
    return launch<dp_s8_kernel<P4, TOut, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid, stream, \
                                             ap, bp, cp, m, n, k, bm, bn, bk, n_tiles_n,         \
                                             tile_offset, n_total, aligned, epi);                \
  else                                                                                           \
    return launch<dp_kernel<TA, TB, P4, TOut, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid,    \
                                                  stream, ap, bp, cp, m, n, k, bm, bn, bk,       \
                                                  n_tiles_n, tile_offset, n_total, aligned, epi)
  switch (sm) {
    case 8: SK_DP(8);
    case 16: SK_DP(16);
    case 32: SK_DP(32);
    case 64: SK_DP(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SK_DP
}

// B1 for one operand pair, either output type (0 = float32, 1 = bfloat16).
template <typename TA, typename TB, bool P4>
int dp_entry(int out_dt, int sm, const void* a, const void* b, void* c, int m, int n, int k,
             int bm, int bn, int bk, int n_tiles_n, int tile_offset, int n_total, int grid,
             int aligned, const void* bias, const void* operand, const void* scale,
             const void* scale_a, int act, int binary, void* stream) {
  const Epilogue epi{bias, operand, static_cast<const float*>(scale),
                     static_cast<const float*>(scale_a), act, binary};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dt == 0)
    return launch_dp<TA, TB, P4, float>(sm, a, b, c, m, n, k, bm, bn, bk, n_tiles_n, tile_offset,
                                        n_total, grid, aligned != 0, epi, s);
  if (out_dt == 1)
    return launch_dp<TA, TB, P4, __nv_bfloat16>(sm, a, b, c, m, n, k, bm, bn, bk, n_tiles_n,
                                                tile_offset, n_total, grid, aligned != 0, epi,
                                                s);
  return (int)cudaErrorInvalidValue;
}

// B2 for one operand pair.
template <typename TA, typename TB, bool P4>
int streamk_entry(int sm, const void* a, const void* b, void* partials, int m, int n, int k,
                  int bm, int bn, int bk, int n_tiles_n, int ipt, int ipw, int total, int mc,
                  int grid, int aligned, void* stream) {
  const TA* ap = static_cast<const TA*>(a);
  const TB* bp = static_cast<const TB*>(b);
  float* p = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
#define SK_P1(S)                                                                       \
  return launch<streamk_kernel<TA, TB, P4, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid, s, \
                                               ap, bp, p, m, n, k, bm, bn, bk, n_tiles_n, ipt, \
                                               ipw, total, mc, al)
  switch (sm) {
    case 8: SK_P1(8);
    case 16: SK_P1(16);
    case 32: SK_P1(32);
    case 64: SK_P1(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SK_P1
}

}  // namespace
