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
// Design. A logical bm x bn tile (any TileConfig: bm a multiple of 8, bn of
// 128) is walked in SM x 128 sub-blocks (SM in {8, 16, 32, 64} divides bm,
// chosen by the host to fit M). 256 threads own the sub-block as 8 row
// groups x 32 column groups; each thread keeps SM/8 x 4 f32 accumulators in
// registers. The K range streams through a ring of kStages shared-memory
// slots of 32-deep chunks (A chunk SM x 32, B chunk 32 x 128, in the input
// type), filled by 16-byte cp.async so that kStages - 1 chunks are in flight
// while the block multiplies the oldest; operands whose rows are not 16-byte
// aligned fill the same ring element by element. The product is SIMT FMA
// into f32: no TF32, so f32 inputs keep full f32 products. The kernels mask
// ragged M, N and K edges themselves (cp.async zero-fills past the edge), so
// the caller pads nothing and never copies a weight. Epilogue order: bias -> activation -> binary, on the f32
// accumulator, then the cast (round to nearest even for bf16).
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kSN = 128;  // sub-block columns
constexpr int kKC = 32;   // K chunk staged through shared memory
constexpr int kStages = 5;  // ring depth: kStages - 1 chunks in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive elements as f32 (a 16- or 8-byte aligned load).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

struct Epilogue {
  const void* bias;     // (N,) in the output type, or null
  const void* operand;  // (M, N) row-major in the output type, or null
  int act;              // 0 none, 1 relu, 2 gelu (tanh), 3 silu, 4 square
  int binary;           // 0 none, 1 mul_silu, 2 add
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <typename TOut>
__device__ __forceinline__ float apply_epilogue(float acc, const Epilogue& e, int64_t row,
                                                int col, int n) {
  if (e.bias != nullptr) acc += to_f32(static_cast<const TOut*>(e.bias)[col]);
  switch (e.act) {
    case 1:
      acc = fmaxf(acc, 0.f);
      break;
    case 2: {
      const float inner = 0.7978845608028654f * (acc + 0.044715f * acc * acc * acc);
      acc = 0.5f * acc * (1.f + tanhf(inner));
      break;
    }
    case 3:
      acc = silu(acc);
      break;
    case 4: {
      const float r = fmaxf(acc, 0.f);
      acc = r * r;
      break;
    }
    default:
      break;
  }
  if (e.binary != 0) {
    const float o = to_f32(static_cast<const TOut*>(e.operand)[row * n + col]);
    acc = e.binary == 1 ? acc * silu(o) : acc + o;
  }
  return acc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one block: kStages ring slots of an A chunk (SM x kKC)
// and a B chunk (kKC x 128), both in the input type.
template <typename TIn, int SM>
constexpr int smem_bytes() {
  return kStages * (SM * kKC + kKC * kSN) * (int)sizeof(TIn);
}

// Copy one K chunk [k0, k0 + kKC) of the sub-block's A rows and B columns
// into ring slot `as`/`bs`. Aligned operands go by 16-byte cp.async (the
// hardware zero-fills what lies past M, N or kend); otherwise element by
// element. Either way the slot holds zeros outside C and the K range.
template <typename TIn, int SM>
__device__ __forceinline__ void load_chunk(const TIn* __restrict__ a, const TIn* __restrict__ b,
                                           int m, int n, int k, int row0, int col0, int k0,
                                           int kend, bool aligned, TIn* as, TIn* bs) {
  constexpr int V = 16 / (int)sizeof(TIn);  // elements per 16-byte copy
  constexpr int A_VECS = SM * kKC / V;
  constexpr int B_VECS = kKC * kSN / V;
  const int t = threadIdx.x;
  for (int e = t; e < A_VECS; e += kThreads) {
    const int r = e / (kKC / V);
    const int kk = (e % (kKC / V)) * V;
    const int gr = row0 + r;
    const int gk = k0 + kk;
    const int valid = gr < m ? min(max(kend - gk, 0), V) : 0;
    const TIn* src = a + (int64_t)gr * k + gk;
    TIn* dst = as + r * kKC + kk;
    if (aligned) {
      cp_async16(dst, valid ? src : a, valid * (int)sizeof(TIn));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = j < valid ? src[j] : from_f32<TIn>(0.f);
    }
  }
  for (int e = t; e < B_VECS; e += kThreads) {
    const int r = e / (kSN / V);
    const int c = (e % (kSN / V)) * V;
    const int gk = k0 + r;
    const int gc = col0 + c;
    const int valid = gk < kend ? min(max(n - gc, 0), V) : 0;
    const TIn* src = b + (int64_t)gk * n + gc;
    TIn* dst = bs + r * kSN + c;
    if (aligned) {
      cp_async16(dst, valid ? src : b, valid * (int)sizeof(TIn));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = j < valid ? src[j] : from_f32<TIn>(0.f);
    }
  }
}

// acc[i][j] = sum_{k in [kbeg, kend)} A[row0 + tm*TM + i, k] * B[k, col0 + tn*4 + j]
// for this thread's rows/columns of one SM x 128 sub-block. The K range
// streams through a kStages-deep ring of shared-memory chunks, kStages - 1
// of them in flight while the block multiplies the oldest one. A sub-block
// entirely outside C accumulates nothing (its sums are zeros).
template <typename TIn, int SM>
__device__ __forceinline__ void mac_subblock(const TIn* __restrict__ a, const TIn* __restrict__ b,
                                             int m, int n, int k, int row0, int col0, int kbeg,
                                             int kend, bool aligned, float (&acc)[SM / 8][4],
                                             TIn* smem) {
  constexpr int TM = SM / 8;
  constexpr int A_SLOT = SM * kKC;
  constexpr int B_SLOT = kKC * kSN;
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (row0 >= m || col0 >= n) return;  // uniform across the block

  TIn* as = smem;
  TIn* bs = smem + kStages * A_SLOT;
  const int nchunks = (kend - kbeg + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks)
      load_chunk<TIn, SM>(a, b, m, n, k, row0, col0, kbeg + s * kKC, kend, aligned,
                          as + s * A_SLOT, bs + s * B_SLOT);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and slot c-1 is free again
    const int next = c + kStages - 1;
    if (next < nchunks) {
      const int slot = next % kStages;
      load_chunk<TIn, SM>(a, b, m, n, k, row0, col0, kbeg + next * kKC, kend, aligned,
                          as + slot * A_SLOT, bs + slot * B_SLOT);
    }
    cp_async_commit();
    const TIn* a_s = as + (c % kStages) * A_SLOT + tm * TM * kKC;
    const TIn* b_s = bs + (c % kStages) * B_SLOT + tn * 4;
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float bv[4];
      load4(b_s + kk * kSN, bv);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = to_f32(a_s[i * kKC + kk]);
        acc[i][0] = fmaf(av, bv[0], acc[i][0]);
        acc[i][1] = fmaf(av, bv[1], acc[i][1]);
        acc[i][2] = fmaf(av, bv[2], acc[i][2]);
        acc[i][3] = fmaf(av, bv[3], acc[i][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the next sub-block refills the ring
}

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

// Opt a kernel into the dynamic shared memory its ring needs (above 48 KB
// only after cudaFuncSetAttribute), then launch it. The attribute stays set
// on the function, so each instantiation sets it once per device and later
// launches skip that call.
constexpr int kMaxDevices = 64;

template <auto Kernel, typename... Args>
int launch(int smem, int grid, cudaStream_t stream, Args... args) {
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  Kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
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
