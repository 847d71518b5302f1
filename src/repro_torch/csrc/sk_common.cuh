// Device code shared by the Stream-K++ kernels for NVIDIA Hopper (sm_90a):
// stream_k.cuh (B1, B2), grouped.cuh (B5) and splitk.cuh (B6) include it.
// It holds what the mainloops of mma_bf16.cuh (bf16 activations), mma_s8.cuh
// (int8) and fma_f32.cuh (f32) share: the block's shape, the epilogue, the
// cp.async helpers, the split-tile tail of B2 and B5's Stream-K form, and
// the launch helper.
//
// A logical bm x bn tile (any TileConfig: bm a multiple of 8, bn of 128) is
// walked in SM x 128 sub-blocks (SM in {8, 16, 32, 64} divides bm, chosen by
// the host to fit M) by kThreads = 256 threads. Each mainloop gives the f32
// sums over a K range [kbeg, kend) of one sub-block of A @ B, with ragged M,
// N and K masked by its loads (callers pad nothing and never copy a weight),
// zeros for a sub-block outside C, and kbeg a multiple of the tile's bk.
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

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
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

// The tail of a split tile, shared by B2 (stream_k.cuh) and B5's Stream-K
// form (grouped.cuh): a contributor has parked its segment's f32 sums in its
// slot; it publishes them and arrives at the tile's counter, and the last of
// the tile's contributors to arrive sums the slots of contributors first_wg
// .. last_wg in ascending order, from 0.f, applies the epilogue and writes
// the tile into C, masked at row_end and n. Nobody waits on anybody, so no
// two blocks need to be resident at once, and the order of the sum is fixed:
// the result is bit-identical from run to run. The last arriver resets the
// counter to 0, so every launch finds the counters at 0 and leaves them so.
// The tile's counter is counters[counter]; `slot_of(w)` is the index of
// contributor w's slot in `ws`, slots of `tile_elems` floats each, a tile's
// rows bn apart; C is row-major with n columns and the tile's corner at
// (row0, col0). `last_arrival` is a __shared__ int of the calling kernel.
template <typename TOut, typename SlotOf>
__device__ __forceinline__ void flush_slots(int first_wg, int last_wg, SlotOf slot_of,
                                            const float* __restrict__ ws, int64_t tile_elems,
                                            TOut* __restrict__ c, const Epilogue& epi, int row0,
                                            int row_end, int col0, int n, int bm, int bn) {
  for (int e = threadIdx.x; e < bm * bn; e += kThreads) {
    const int64_t row = row0 + e / bn;
    const int col = col0 + e % bn;
    if (row >= row_end || col >= n) continue;
    float sum = 0.f;
    for (int w = first_wg; w <= last_wg; ++w)
      sum += __ldcg(ws + slot_of(w) * tile_elems + e);  // L2: the slots of other SMs
    c[row * n + col] = from_f32<TOut>(apply_epilogue<TOut>(sum, epi, row, col, n));
  }
}

template <typename TOut, typename SlotOf>
__device__ __forceinline__ void fix_up_split_tile(int* __restrict__ counters, int counter,
                                                  int first_wg, int last_wg, SlotOf slot_of,
                                                  const float* __restrict__ ws,
                                                  int64_t tile_elems, TOut* __restrict__ c,
                                                  const Epilogue& epi, int row0, int row_end,
                                                  int col0, int n, int bm, int bn,
                                                  int& last_arrival) {
  // Publish the slot, then arrive.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(&counters[counter], 1);
    last_arrival = prev == last_wg - first_wg;
    if (last_arrival) {
      counters[counter] = 0;  // every contributor has arrived: ready for the next launch
      __threadfence();        // acquire the other contributors' slots
    }
  }
  __syncthreads();
  if (last_arrival)
    flush_slots<TOut>(first_wg, last_wg, slot_of, ws, tile_elems, c, epi, row0, row_end, col0, n,
                      bm, bn);
  __syncthreads();  // last_arrival is reused by the block's next split segment
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
