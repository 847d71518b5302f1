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
// The sub-block MAC, its cp.async ring, the epilogue and the launch helper
// live in sk_common.cuh, which grouped.cu (B5) shares.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include "sk_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B1: data-parallel region
// ---------------------------------------------------------------------------

template <typename TIn, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads)
    dp_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b, TOut* __restrict__ c, int m,
              int n, int k, int bm, int bn, int n_tiles_n, int tile_offset, int n_total,
              bool aligned, Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TIn* smem = reinterpret_cast<TIn*>(smem_raw);
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
        mac_subblock<TIn, SM>(a, b, m, n, k, row0, col0, 0, k, aligned, acc, smem);
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

// ---------------------------------------------------------------------------
// B2: the Stream-K sweep
// ---------------------------------------------------------------------------

template <typename TIn, int SM>
__global__ void __launch_bounds__(kThreads)
    streamk_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                   float* __restrict__ partials, int m, int n, int k, int bm, int bn, int bk,
                   int n_tiles_n, int ipt, int ipw, int total, int mc, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TIn* smem = reinterpret_cast<TIn*>(smem_raw);
  constexpr int TM = SM / 8;
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
  const int x = blockIdx.x;
  const int64_t start = (int64_t)x * ipw;
  if (start >= total) return;
  const int end = (int)min((int64_t)total, start + ipw);
  float acc[TM][4];
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
        mac_subblock<TIn, SM>(a, b, m, n, k, tile_m * bm + sm0, tile_n * bn + sn0, kbeg, kend,
                              aligned, acc, smem);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float* dst = out + (int64_t)(sm0 + tm * TM + i) * bn + sn0 + tn * 4;
          *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

template <typename TIn, typename TOut>
int launch_dp(int sm, const void* a, const void* b, void* c, int m, int n, int k, int bm, int bn,
              int n_tiles_n, int tile_offset, int n_total, int grid, bool aligned, Epilogue epi,
              cudaStream_t stream) {
  const TIn* ap = static_cast<const TIn*>(a);
  const TIn* bp = static_cast<const TIn*>(b);
  TOut* cp = static_cast<TOut*>(c);
#define SK_DP(S)                                                                             \
  return launch<dp_kernel<TIn, TOut, S>>(smem_bytes<TIn, S>(), grid, stream, ap, bp, cp, m, n, \
                                        k, bm, bn, n_tiles_n, tile_offset, n_total, aligned, epi)
  switch (sm) {
    case 8: SK_DP(8);
    case 16: SK_DP(16);
    case 32: SK_DP(32);
    case 64: SK_DP(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SK_DP
}

template <typename TIn>
int launch_streamk(int sm, const void* a, const void* b, float* partials, int m, int n, int k,
                   int bm, int bn, int bk, int n_tiles_n, int ipt, int ipw, int total, int mc,
                   int grid, bool aligned, cudaStream_t stream) {
  const TIn* ap = static_cast<const TIn*>(a);
  const TIn* bp = static_cast<const TIn*>(b);
#define SK_P1(S)                                                                           \
  return launch<streamk_kernel<TIn, S>>(smem_bytes<TIn, S>(), grid, stream, ap, bp, partials, \
                                       m, n, k, bm, bn, bk, n_tiles_n, ipt, ipw, total, mc,     \
                                       aligned)
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

// Dtype codes: 0 = float32, 1 = bfloat16.
extern "C" {

int sk_dp_gemm(int in_dt, int out_dt, int sm, const void* a, const void* b, void* c, int m, int n,
               int k, int bm, int bn, int n_tiles_n, int tile_offset, int n_total, int grid,
               int aligned, const void* bias, const void* operand, int act, int binary,
               void* stream) {
  const Epilogue epi{bias, operand, act, binary};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vb = aligned != 0;
  if (in_dt == 0 && out_dt == 0)
    return launch_dp<float, float>(sm, a, b, c, m, n, k, bm, bn, n_tiles_n, tile_offset, n_total,
                                   grid, vb, epi, s);
  if (in_dt == 0 && out_dt == 1)
    return launch_dp<float, __nv_bfloat16>(sm, a, b, c, m, n, k, bm, bn, n_tiles_n, tile_offset,
                                           n_total, grid, vb, epi, s);
  if (in_dt == 1 && out_dt == 0)
    return launch_dp<__nv_bfloat16, float>(sm, a, b, c, m, n, k, bm, bn, n_tiles_n, tile_offset,
                                           n_total, grid, vb, epi, s);
  if (in_dt == 1 && out_dt == 1)
    return launch_dp<__nv_bfloat16, __nv_bfloat16>(sm, a, b, c, m, n, k, bm, bn, n_tiles_n,
                                                   tile_offset, n_total, grid, vb, epi, s);
  return (int)cudaErrorInvalidValue;
}

int sk_streamk_phase1(int in_dt, int sm, const void* a, const void* b, void* partials, int m,
                      int n, int k, int bm, int bn, int bk, int n_tiles_n, int ipt, int ipw,
                      int total, int mc, int grid, int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  if (in_dt == 0)
    return launch_streamk<float>(sm, a, b, p, m, n, k, bm, bn, bk, n_tiles_n, ipt, ipw, total, mc,
                                 grid, aligned != 0, s);
  if (in_dt == 1)
    return launch_streamk<__nv_bfloat16>(sm, a, b, p, m, n, k, bm, bn, bk, n_tiles_n, ipt, ipw,
                                         total, mc, grid, aligned != 0, s);
  return (int)cudaErrorInvalidValue;
}

int sk_streamk_fixup(int out_dt, const void* partials, void* c, int m, int n, int bm, int bn,
                     int n_tiles_n, int ipt, int ipw, int mc, int sk_tiles, const void* bias,
                     const void* operand, int act, int binary, void* stream) {
  const Epilogue epi{bias, operand, act, binary};
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
