// B5's kernels, the grouped (MoE) GEMM: see grouped.cu for the design.
// grouped.cu instantiates them for f32 inputs, grouped_bf16.cu for bf16
// inputs and each quant_*.cu for one pair of the quantization ladder, so
// the sources compile in parallel. With bf16 activations (the dense bf16,
// int8 and int4 rungs) each sub-block runs the tensor-core mainloop of
// mma_bf16.cuh, with int8 activations (int8 or packed int4 weights) the s8
// tensor-core mainloop of mma_s8.cuh; f32 activations run sk_common.cuh's
// SIMT loop.

#pragma once

#include "mma_bf16.cuh"
#include "mma_s8.cuh"
#include "sk_common.cuh"

namespace {

// One row-block of the concatenated space: its group, its first row within
// the group, and the group row it ends before (min(sizes[group], row0 + bm)).
struct RowBlock {
  int group, row0, row_end;
};

__device__ __forceinline__ RowBlock row_block(const int* __restrict__ tab, int r) {
  return RowBlock{tab[3 * r], tab[3 * r + 1], tab[3 * r + 2]};
}

// Group i's operands, reached through its base pointers. B's rows per group
// are K, or ceil(K / 2) packed int4 rows; the dequant scales are per group:
// scale (G, N) and scale_a (G, M).
template <typename TA, typename TB, typename TOut>
struct Group {
  const TA* a;
  const TB* b;
  TOut* c;
  Epilogue epi;
};

template <bool P4, typename TA, typename TB, typename TOut>
__device__ __forceinline__ Group<TA, TB, TOut> group_of(const TA* a, const TB* b, TOut* c,
                                                        const Epilogue& epi, int i, int m, int n,
                                                        int k) {
  const int64_t b_rows = P4 ? (k + 1) / 2 : k;
  Group<TA, TB, TOut> g{a + (int64_t)i * m * k, b + (int64_t)i * b_rows * n,
                        c + (int64_t)i * m * n, epi};
  if (epi.bias != nullptr) g.epi.bias = static_cast<const TOut*>(epi.bias) + (int64_t)i * n;
  if (epi.operand != nullptr)
    g.epi.operand = static_cast<const TOut*>(epi.operand) + (int64_t)i * m * n;
  if (epi.scale != nullptr) g.epi.scale = epi.scale + (int64_t)i * n;
  if (epi.scale_a != nullptr) g.epi.scale_a = epi.scale_a + (int64_t)i * m;
  return g;
}

// Flush one multiplied sub-block through the epilogue into C.
template <typename TOut, int SM, typename TA, typename TB>
__device__ __forceinline__ void store_subblock(const Group<TA, TB, TOut>& g,
                                               const float (&acc)[SM / 8][4], int row_end,
                                               int row0, int col0, int n) {
  constexpr int TM = SM / 8;
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = row0 + tm * TM + i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tn * 4 + j;
      if (col < n)
        g.c[row * n + col] = from_f32<TOut>(apply_epilogue<TOut>(acc[i][j], g.epi, row, col, n));
    }
  }
}

// ---------------------------------------------------------------------------
// Stream-K form
// ---------------------------------------------------------------------------

template <typename TA, typename TB, bool P4, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads)
    grouped_sk_kernel(const TA* __restrict__ a, const TB* __restrict__ b, TOut* __restrict__ c,
                      const int* __restrict__ tab, float* __restrict__ ws,
                      int* __restrict__ counters, int m, int n, int k, int bm, int bn, int bk,
                      int nt, int ipt, int ipw, int total, bool aligned, Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* smem = reinterpret_cast<TA*>(smem_raw);
  __shared__ int last_arrival;
  constexpr int TM = SM / 8;
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
  const int x = blockIdx.x;
  const int64_t start = (int64_t)x * ipw;
  if (start >= total) return;
  const int end = (int)min((int64_t)total, start + ipw);
  const int64_t tile_elems = (int64_t)bm * bn;
  int it = (int)start;
  while (it < end) {
    const int t = it / ipt;
    const int seg_end = min(end, (t + 1) * ipt);
    const RowBlock rb = row_block(tab, t / nt);
    const int tile_n = t % nt;
    const Group<TA, TB, TOut> g = group_of<P4>(a, b, c, epi, rb.group, m, n, k);
    const int first_wg = (int)((int64_t)t * ipt / ipw);
    const int last_wg = (int)(((int64_t)(t + 1) * ipt - 1) / ipw);
    const bool whole = first_wg == last_wg;  // this block owns the whole tile
    const int kbeg = (it - t * ipt) * bk;
    const int kend = min((seg_end - t * ipt) * bk, k);
    // a segment of a split tile parks its partial in this block's slot
    float* out = whole ? nullptr
                       : ws + (2 * x + ((int64_t)x * ipw >= (int64_t)t * ipt ? 0 : 1)) * tile_elems;
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = rb.row0 + sm0;
      if (row0 >= rb.row_end) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = tile_n * bn + sn0;
        if (col0 >= n) break;
        if constexpr (uses_mma<TA>()) {
          float acc[mma_mt<SM>()][2][4];
          mma_subblock<TB, P4, SM>(g.a, g.b, rb.row_end, n, k, row0, col0, kbeg, kend, aligned,
                                   acc, smem_raw);
          if (whole)
            store_subblock_mma<SM>(g.c, g.epi, acc, rb.row_end, row0, col0, n);
          else
            park_subblock_mma<SM>(acc, out + (int64_t)sm0 * bn + sn0, bn);
        } else if constexpr (std::is_same<TA, int8_t>::value) {
          float acc[mma_mt<SM>()][2][4];
          mma_s8_subblock<P4, SM>(g.a, g.b, rb.row_end, n, k, row0, col0, kbeg, kend, bk,
                                  aligned, acc, smem_raw);
          if (whole)
            store_subblock_mma<SM>(g.c, g.epi, acc, rb.row_end, row0, col0, n);
          else
            park_subblock_mma<SM>(acc, out + (int64_t)sm0 * bn + sn0, bn);
        } else {
          float acc[TM][4];
          mac_subblock<TA, TB, P4, SM>(g.a, g.b, rb.row_end, n, k, row0, col0, kbeg, kend, bk,
                                       aligned, acc, smem);
          if (whole) {
            store_subblock<TOut, SM>(g, acc, rb.row_end, row0, col0, n);
          } else {
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              float* dst = out + (int64_t)(sm0 + tm * TM + i) * bn + sn0 + tn * 4;
              *reinterpret_cast<float4*>(dst) =
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            }
          }
        }
      }
    }
    if (whole) {
      it = seg_end;
      continue;
    }
    // Publish the slot, then arrive; the last of the tile's contributors
    // finishes it. Nobody waits on anybody.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int prev = atomicAdd(&counters[first_wg], 1);
      last_arrival = prev == last_wg - first_wg;
      if (last_arrival) {
        counters[first_wg] = 0;  // every contributor has arrived: ready for the next launch
        __threadfence();         // acquire the other contributors' slots
      }
    }
    __syncthreads();
    if (last_arrival) {
      for (int e = threadIdx.x; e < bm * bn; e += kThreads) {
        const int64_t row = rb.row0 + e / bn;
        const int col = tile_n * bn + e % bn;
        if (row >= rb.row_end || col >= n) continue;
        float sum = 0.f;
        for (int w = first_wg; w <= last_wg; ++w) {
          const int slot = 2 * w + ((int64_t)w * ipw >= (int64_t)t * ipt ? 0 : 1);
          sum += __ldcg(ws + slot * tile_elems + e);  // L2: the slots of other SMs
        }
        g.c[row * n + col] = from_f32<TOut>(apply_epilogue<TOut>(sum, g.epi, row, col, n));
      }
    }
    __syncthreads();  // last_arrival is reused by the next split segment
    it = seg_end;
  }
}

// ---------------------------------------------------------------------------
// DP form
// ---------------------------------------------------------------------------

template <typename TA, typename TB, bool P4, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads)
    grouped_dp_kernel(const TA* __restrict__ a, const TB* __restrict__ b, TOut* __restrict__ c,
                      const int* __restrict__ tab, int m, int n, int k, int bm, int bn, int bk,
                      int nt, int n_tiles, bool aligned, Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* smem = reinterpret_cast<TA*>(smem_raw);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const RowBlock rb = row_block(tab, t / nt);
    const Group<TA, TB, TOut> g = group_of<P4>(a, b, c, epi, rb.group, m, n, k);
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      const int row0 = rb.row0 + sm0;
      if (row0 >= rb.row_end) break;
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int col0 = (t % nt) * bn + sn0;
        if (col0 >= n) break;
        if constexpr (uses_mma<TA>()) {
          float acc[mma_mt<SM>()][2][4];
          mma_subblock<TB, P4, SM>(g.a, g.b, rb.row_end, n, k, row0, col0, 0, k, aligned, acc,
                                   smem_raw);
          store_subblock_mma<SM>(g.c, g.epi, acc, rb.row_end, row0, col0, n);
        } else if constexpr (std::is_same<TA, int8_t>::value) {
          float acc[mma_mt<SM>()][2][4];
          mma_s8_subblock<P4, SM>(g.a, g.b, rb.row_end, n, k, row0, col0, 0, k, bk, aligned, acc,
                                  smem_raw);
          store_subblock_mma<SM>(g.c, g.epi, acc, rb.row_end, row0, col0, n);
        } else {
          float acc[SM / 8][4];
          mac_subblock<TA, TB, P4, SM>(g.a, g.b, rb.row_end, n, k, row0, col0, 0, k, bk, aligned,
                                       acc, smem);
          store_subblock<TOut, SM>(g, acc, rb.row_end, row0, col0, n);
        }
      }
    }
  }
}

template <typename TA, typename TB, bool P4, typename TOut>
int launch_grouped(int sm, bool sk_form, const void* a, const void* b, void* c, const int* tab,
                   float* ws, int* counters, int m, int n, int k, int bm, int bn, int bk, int nt,
                   int n_tiles, int ipt, int ipw, int grid, bool aligned, Epilogue epi,
                   cudaStream_t stream) {
  const TA* ap = static_cast<const TA*>(a);
  const TB* bp = static_cast<const TB*>(b);
  TOut* cp = static_cast<TOut*>(c);
  const int total = n_tiles * ipt;
#define SK_GROUPED(S)                                                                        \
  if (sk_form)                                                                               \
    return launch<grouped_sk_kernel<TA, TB, P4, TOut, S>>(                                   \
        mainloop_smem_bytes<TA, TB, P4, S>(), grid, stream, ap, bp, cp, tab, ws, counters,   \
        m, n, k, bm, bn, bk, nt, ipt, ipw, total, aligned, epi);                             \
  return launch<grouped_dp_kernel<TA, TB, P4, TOut, S>>(                                     \
      mainloop_smem_bytes<TA, TB, P4, S>(), grid, stream, ap, bp, cp, tab, m, n, k, bm, bn,  \
      bk, nt, n_tiles, aligned, epi)
  switch (sm) {
    case 8: SK_GROUPED(8);
    case 16: SK_GROUPED(16);
    case 32: SK_GROUPED(32);
    case 64: SK_GROUPED(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SK_GROUPED
}

// The launch of one grouped GEMM of one operand pair, for either output
// type (0 = float32, 1 = bfloat16).
template <typename TA, typename TB, bool P4>
int grouped_entry(int out_dt, int sm, int sk_form, const void* a, const void* b, void* c,
                  const void* tab, void* ws, void* counters, int m, int n, int k, int bm, int bn,
                  int bk, int nt, int n_tiles, int ipt, int ipw, int grid, int aligned,
                  const void* bias, const void* operand, const void* scale, const void* scale_a,
                  int act, int binary, void* stream) {
  const Epilogue epi{bias, operand, static_cast<const float*>(scale),
                     static_cast<const float*>(scale_a), act, binary};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tab);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (out_dt == 0)
    return launch_grouped<TA, TB, P4, float>(sm, sk_form != 0, a, b, c, t, w, cnt, m, n, k, bm,
                                             bn, bk, nt, n_tiles, ipt, ipw, grid, aligned != 0,
                                             epi, s);
  if (out_dt == 1)
    return launch_grouped<TA, TB, P4, __nv_bfloat16>(sm, sk_form != 0, a, b, c, t, w, cnt, m, n,
                                                     k, bm, bn, bk, nt, n_tiles, ipt, ipw, grid,
                                                     aligned != 0, epi, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
