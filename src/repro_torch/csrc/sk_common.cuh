// Device code shared by the Stream-K++ kernels for NVIDIA Hopper (sm_90a):
// stream_k.cu (B1-B3) and grouped.cu (B5) include it.
//
// A logical bm x bn tile (any TileConfig: bm a multiple of 8, bn of 128) is
// walked in SM x 128 sub-blocks (SM in {8, 16, 32, 64} divides bm, chosen by
// the host to fit M). 256 threads own the sub-block as 8 row groups x 32
// column groups; each thread keeps SM/8 x 4 f32 accumulators in registers.
// The K range streams through a ring of kStages shared-memory slots of
// 32-deep chunks (A chunk SM x 32, B chunk 32 x 128, in the input type),
// filled by 16-byte cp.async so that kStages - 1 chunks are in flight while
// the block multiplies the oldest; operands whose rows are not 16-byte
// aligned fill the same ring element by element. The product is SIMT FMA
// into f32: no TF32, so f32 inputs keep full f32 products. The loads mask
// ragged M, N and K edges (cp.async zero-fills past the edge), so callers pad
// nothing and never copy a weight. Epilogue order: bias -> activation ->
// binary, on the f32 accumulator, then the cast (round to nearest even for
// bf16).
//
// Everything here sits in an anonymous namespace: each source that includes
// the header gets its own copy, and no symbol crosses between them.

#pragma once

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

}  // namespace
