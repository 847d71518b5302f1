// Device code shared by the Stream-K++ kernels for NVIDIA Hopper (sm_90a):
// stream_k.cuh (B1-B3), grouped.cuh (B5) and splitk.cuh (B6) include it.
// Its SIMT mainloop, mac_subblock, serves the f32-activation rungs of B5's
// Stream-K form alone; the other rungs and kernels run the loops of
// mma_bf16.cuh (bf16 activations), mma_s8.cuh (int8) and fma_f32.cuh (f32:
// B1, B2, B5's DP form and B6), which keep its contract.
//
// A logical bm x bn tile (any TileConfig: bm a multiple of 8, bn of 128) is
// walked in SM x 128 sub-blocks (SM in {8, 16, 32, 64} divides bm, chosen by
// the host to fit M). 256 threads own the sub-block as 8 row groups x 32
// column groups; each thread keeps SM/8 x 4 f32 accumulators in registers.
// The K range streams through a ring of kStages shared-memory slots of
// 32-deep chunks (A chunk SM x 32 in A's type, B chunk 32 x 128 in B's type,
// or 16 x 128 bytes of packed int4), filled by 16-byte cp.async so that
// kStages - 1 chunks are in flight while the block multiplies the oldest;
// operands whose rows are not 16-byte aligned fill the same ring element by
// element. The loads mask ragged M, N and K edges (cp.async zero-fills past
// the edge), so callers pad nothing and never copy a weight.
//
// The MAC (the TPU's mixed_dot, src/repro/kernels/common.py:125) is an f32
// FMA, no TF32, so f32 inputs keep full f32 products; int8 or packed int4
// weights are widened to f32 (exact) first. Packed int4 B (two nibbles per
// byte along K, even k in the low nibble, src/repro/core/quant.py:83-110)
// is staged packed, half a byte per weight, and each nibble is
// sign-extended as it is multiplied; a chunk starts on an even k, and
// packed rows are masked against ceil(kend / 2).
//
// Epilogue order (src/repro/kernels/common.py:81-104): scale_a (per row) ->
// scale (per column) -> bias -> activation -> binary, on the f32
// accumulator, then the cast (round to nearest even for bf16).
//
// Everything here sits in an anonymous namespace: each source that includes
// the header gets its own copy, and no symbol crosses between them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSN = 128;  // sub-block columns
constexpr int kKC = 32;   // K chunk staged through shared memory
constexpr int kStages = 5;  // ring depth: kStages - 1 chunks in flight

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive B elements of one k row, widened to f32.
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

__device__ __forceinline__ void load4(const int8_t* p, float v[4]) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  v[0] = (float)q.x; v[1] = (float)q.y; v[2] = (float)q.z; v[3] = (float)q.w;
}

// Four packed int4 bytes of one packed row: lo[j] is the even k (low
// nibble), hi[j] the odd k (high nibble) of column j, sign-extended.
__device__ __forceinline__ void unpack4(const int8_t* p, float lo[4], float hi[4]) {
  const unsigned word = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned byte = (word >> (8 * j)) & 0xFFu;
    lo[j] = (float)((int)(byte << 28) >> 28);
    hi[j] = (float)((int)(byte << 24) >> 28);
  }
}

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

struct Epilogue {
  const void* bias;      // (N,) in the output type, or null
  const void* operand;   // (M, N) row-major in the output type, or null
  const float* scale;    // (N,) per-output-channel weight dequant, or null
  const float* scale_a;  // (M,) per-row activation dequant, or null
  int act;               // 0 none, 1 relu, 2 gelu (tanh), 3 silu, 4 square
  int binary;            // 0 none, 1 mul_silu, 2 add
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <typename TOut>
__device__ __forceinline__ float apply_epilogue(float acc, const Epilogue& e, int64_t row,
                                                int col, int n) {
  if (e.scale_a != nullptr) acc *= e.scale_a[row];
  if (e.scale != nullptr) acc *= e.scale[col];
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

// Rows of B one K chunk stages: kKC, or kKC / 2 packed rows of int4.
template <bool P4>
__host__ __device__ constexpr int b_rows() { return P4 ? kKC / 2 : kKC; }

// Bytes of one ring slot's A chunk (SM x kKC) and B chunk.
template <typename TA, int SM>
__host__ __device__ constexpr int a_slot_bytes() { return SM * kKC * (int)sizeof(TA); }
template <typename TB, bool P4>
__host__ __device__ constexpr int b_slot_bytes() { return b_rows<P4>() * kSN * (int)sizeof(TB); }

// Shared memory of one block: kStages ring slots of an A chunk and a B chunk.
template <typename TA, typename TB, bool P4, int SM>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (a_slot_bytes<TA, SM>() + b_slot_bytes<TB, P4>());
}

// Copy one K chunk [k0, k0 + kKC) of the sub-block's A rows and B columns
// into ring slot `as`/`bs`. Aligned operands go by 16-byte cp.async (the
// hardware zero-fills what lies past M, N or kend); otherwise element by
// element. Either way the slot holds zeros outside C and the K range. For
// packed int4 B the chunk is packed rows [k0 / 2, k0 / 2 + kKC / 2), masked
// against ceil(kend / 2) (k0 is even: kbeg is a multiple of bk).
template <typename TA, typename TB, bool P4, int SM>
__device__ __forceinline__ void load_chunk(const TA* __restrict__ a, const TB* __restrict__ b,
                                           int m, int n, int k, int row0, int col0, int k0,
                                           int kend, bool aligned, TA* as, TB* bs) {
  constexpr int VA = 16 / (int)sizeof(TA);  // elements per 16-byte copy
  constexpr int VB = 16 / (int)sizeof(TB);
  constexpr int A_VECS = SM * kKC / VA;
  constexpr int B_VECS = b_rows<P4>() * kSN / VB;
  const int t = threadIdx.x;
  for (int e = t; e < A_VECS; e += kThreads) {
    const int r = e / (kKC / VA);
    const int kk = (e % (kKC / VA)) * VA;
    const int gr = row0 + r;
    const int gk = k0 + kk;
    const int valid = gr < m ? min(max(kend - gk, 0), VA) : 0;
    const TA* src = a + (int64_t)gr * k + gk;
    TA* dst = as + r * kKC + kk;
    if (aligned) {
      cp_async16(dst, valid ? src : a, valid * (int)sizeof(TA));
    } else {
#pragma unroll
      for (int j = 0; j < VA; ++j) dst[j] = j < valid ? src[j] : zero_of<TA>();
    }
  }
  const int r0 = P4 ? k0 / 2 : k0;              // first (packed) row of the chunk
  const int rend = P4 ? (kend + 1) / 2 : kend;  // (packed) rows of B in range
  for (int e = t; e < B_VECS; e += kThreads) {
    const int r = e / (kSN / VB);
    const int c = (e % (kSN / VB)) * VB;
    const int gk = r0 + r;
    const int gc = col0 + c;
    const int valid = gk < rend ? min(max(n - gc, 0), VB) : 0;
    const TB* src = b + (int64_t)gk * n + gc;
    TB* dst = bs + r * kSN + c;
    if (aligned) {
      cp_async16(dst, valid ? src : b, valid * (int)sizeof(TB));
    } else {
#pragma unroll
      for (int j = 0; j < VB; ++j) dst[j] = j < valid ? src[j] : zero_of<TB>();
    }
  }
}

// One staged chunk into the thread's sums s (TM rows x 4 columns).
template <typename TA, typename TB, bool P4, int TM>
__device__ __forceinline__ void mac_chunk(const TA* a_s, const TB* b_s, float (&s)[TM][4]) {
  if constexpr (P4) {
#pragma unroll 4
    for (int kp = 0; kp < kKC / 2; ++kp) {
      float lo[4], hi[4];
      unpack4(b_s + kp * kSN, lo, hi);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a0 = widen(a_s[i * kKC + 2 * kp]);
        const float a1 = widen(a_s[i * kKC + 2 * kp + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a1, hi[j], fmaf(a0, lo[j], s[i][j]));
      }
    }
  } else {
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float bv[4];
      load4(b_s + kk * kSN, bv);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = widen(a_s[i * kKC + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av, bv[j], s[i][j]);
      }
    }
  }
}

// acc[i][j] = sum_{k in [kbeg, kend)} A[row0 + tm*TM + i, k] * B[k, col0 + tn*4 + j]
// for this thread's rows/columns of one SM x 128 sub-block. The K range
// streams through a kStages-deep ring of shared-memory chunks, kStages - 1
// of them in flight while the block multiplies the oldest one. kbeg is a
// multiple of bk. A sub-block entirely outside C accumulates nothing (its
// sums are zeros).
template <typename TA, typename TB, bool P4, int SM>
__device__ __forceinline__ void mac_subblock(const TA* __restrict__ a, const TB* __restrict__ b,
                                             int m, int n, int k, int row0, int col0, int kbeg,
                                             int kend, bool aligned, float (&acc)[SM / 8][4],
                                             TA* smem) {
  constexpr int TM = SM / 8;
  constexpr int A_SLOT = SM * kKC;          // elements of TA
  constexpr int B_SLOT = b_rows<P4>() * kSN;  // elements of TB
  const int tn = threadIdx.x & 31;
  const int tm = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (row0 >= m || col0 >= n) return;  // uniform across the block

  TA* as = smem;
  TB* bs = reinterpret_cast<TB*>(smem + kStages * A_SLOT);
  const int nchunks = (kend - kbeg + kKC - 1) / kKC;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nchunks)
      load_chunk<TA, TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg + st * kKC, kend, aligned,
                                 as + st * A_SLOT, bs + st * B_SLOT);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and slot c-1 is free again
    const int next = c + kStages - 1;
    if (next < nchunks) {
      const int slot = next % kStages;
      load_chunk<TA, TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg + next * kKC, kend, aligned,
                                 as + slot * A_SLOT, bs + slot * B_SLOT);
    }
    cp_async_commit();
    const TA* a_s = as + (c % kStages) * A_SLOT + tm * TM * kKC;
    const TB* b_s = bs + (c % kStages) * B_SLOT + tn * 4;
    mac_chunk<TA, TB, P4, TM>(a_s, b_s, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the next sub-block refills the ring
}

// Opt a kernel into the dynamic shared memory its ring needs (above 48 KB
// only after cudaFuncSetAttribute), then launch it on a 1-D grid (an int)
// or a 2-D one (B6's tiles x splits). The attribute stays set
// on the function, so each instantiation sets it once per device and later
// launches skip that call.
constexpr int kMaxDevices = 64;

template <auto Kernel, typename... Args>
int launch(int smem, dim3 grid, cudaStream_t stream, Args... args) {
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
