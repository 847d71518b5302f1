// B1's and B2's kernels, templated on the operand types: see stream_k.cu for the
// design. stream_k.cu instantiates them for the dense f32 and bf16 inputs,
// and each quant_*.cu for one pair of the quantization ladder, so the
// sources compile in parallel. With bf16 activations (the dense bf16, int8
// and int4 rungs) each sub-block of B1 and B2 runs the tensor-core mainloop
// of mma_bf16.cuh, with int8 activations (int8 or packed int4 weights) the
// s8 tensor-core mainloop of mma_s8.cuh, with f32 activations (f32, int8 or
// packed int4 weights) the f32 FMA mainloop of fma_f32.cuh. B2 finishes its
// split tiles itself (B3, the fix-up, is fused into its tail), so one
// launch computes a Stream-K region.

#pragma once

#include "fma_f32.cuh"
#include "mma_s8.cuh"

namespace {

// ---------------------------------------------------------------------------
// B1: data-parallel region
// ---------------------------------------------------------------------------

// B1 on the f32 FMA mainloop, for f32 activations (f32, int8 or packed
// int4 weights): g blocks stride over the output tiles [tile_offset,
// n_total); each SM x 128 sub-block of a tile is multiplied by fma_subblock
// over all of K and flushed through the epilogue, masked at M and N. B1's
// three mainloops are kernels of their own and not compile-time branches
// inside one: such a branch once moved the SASS of the instantiations it
// did not take (int8 x int8 at SM = 8 ran 2.5 % slower on the H100).
template <typename TB, bool P4, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads)
    dp_fma_kernel(const float* __restrict__ a, const TB* __restrict__ b, TOut* __restrict__ c,
                  int m, int n, int k, int bm, int bn, int n_tiles_n, int tile_offset,
                  int n_total, bool aligned, Epilogue epi) {
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
        float acc[SM][fma_tn<SM>()];
        fma_subblock<TB, P4, SM>(a, b, m, n, k, row0, col0, 0, k, aligned, acc, smem_raw);
        store_subblock_fma<SM>(c, epi, acc, m, row0, col0, n);
      }
    }
  }
}

// B1 on the tensor-core mainloop, for bf16 activations: dp_fma_kernel's
// walk over the tiles, each sub-block multiplied by mma_subblock and flushed
// from its fragments.
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
// accumulator at every bk step in order, as kstep_dot does (so C with the
// dequant scales alone is the plain version's, bit for bit), and flushed
// from its fragments.
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
// B2: the Stream-K sweep, with B3's fix-up fused into its tail
// ---------------------------------------------------------------------------

// Block x walks its MAC iterations [x * ipw, min((x + 1) * ipw, total)) of
// the Stream-K region tile segment by tile segment. Each SM x 128 sub-block
// of a segment runs the mainloop of its activations over the segment's
// [kbeg, kend), kbeg a multiple of bk: mma_subblock (bf16), mma_s8_subblock
// (int8) or fma_subblock (f32). A tile that the block owns whole
// (first_wg == last_wg) is flushed from registers through the epilogue into
// C and never touches the workspace. A segment of a split tile parks its
// sums in its slot partials[tile, x - first_wg] of the (sk_tiles, mc + 1,
// bm, bn) workspace, all SM rows and 128 columns (zeros outside C), and
// arrives at the tile's counter; the last contributor to arrive sums slots
// 0 .. n_contrib - 1 in ascending order from 0.f (fix_up_split_tile), B3's
// order and first addend, applies the epilogue and writes the tile into C.
// The whole tile's flush is that sum too: 0.f + x is x for every x but -0.0,
// which no sum that starts at +0.0 gives.
//
// Dense f32 runs fma_subblock's k-ordered map: olmoe's router is this pair,
// and its served routing is its logits' top-8, where near-tied experts flip
// on any change of rounding and each flip moves the logits on; summed one
// FMA per k in k order, the router's logits are torch.matmul's bit for bit
// at the router's shapes on the H100 (chip_smoke.py reads the difference). That map
// parks a whole tile too, in its slot 0, and the block flushes the slot
// after a barrier (flush_slots: 0.f + each sum, B3's bits exactly): flushed
// from registers, its unrolled store spilled (40/116 bytes at SM = 64),
// where parked it spills nowhere.
//
// __launch_bounds__(256, 1): without it ptxas held several instantiations
// to 40-128 registers for occupancy and spilled once the epilogue's flush
// joined the mainloop (up to 48/512 bytes); with it none spills (PERF.md
// §7 has the counts). Dense f32 at SM = 32 and 64 and int8 x int4 at
// SM = 64 then pass 128 registers and fit one block an SM, so a grid of
// 264 (two blocks an SM) runs there in two waves: kernel_ab.py --occupancy
// times it (PERF.md §6).
template <typename TA, typename TB, bool P4, typename TOut, int SM>
__global__ void __launch_bounds__(kThreads, 1)
    streamk_kernel(const TA* __restrict__ a, const TB* __restrict__ b, TOut* __restrict__ c,
                   float* __restrict__ partials, int* __restrict__ counters, int m, int n, int k,
                   int bm, int bn, int bk, int n_tiles_n, int ipt, int ipw, int total, int mc,
                   bool aligned, Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_arrival;
  constexpr bool kOrdered = std::is_same<TA, float>::value && std::is_same<TB, float>::value;
  const int x = blockIdx.x;
  const int64_t start = (int64_t)x * ipw;
  if (start >= total) return;
  const int end = (int)min((int64_t)total, start + ipw);
  const int64_t tile_elems = (int64_t)bm * bn;
  int it = (int)start;
  while (it < end) {
    const int tile = it / ipt;
    const int seg_end = min(end, (tile + 1) * ipt);
    const int kbeg = (it - tile * ipt) * bk;
    const int kend = min((seg_end - tile * ipt) * bk, k);
    const int first_wg = (tile * ipt) / ipw;
    const int last_wg = ((tile + 1) * ipt - 1) / ipw;
    const bool whole = first_wg == last_wg;  // this block owns the whole tile
    const int slot = min(max(x - first_wg, 0), mc - 1);
    const int tile_m = tile / n_tiles_n;
    const int tile_n = tile % n_tiles_n;
    // the corner of sub-block (sm0, sn0) in the segment's slot. At the f32
    // maps' 255-register ceiling, whether ptxas spills depends on whether the
    // slot's pointer lives across the mainloop: it does at SM = 64 only,
    // where that form keeps every pair spill-free (sass_ab.py reports spills)
    float* const slot_ptr = partials + ((int64_t)tile * (mc + 1) + slot) * tile_elems;
    auto out = [&](int sm0, int sn0) {
      if constexpr (SM == 64)
        return slot_ptr + (int64_t)sm0 * bn + sn0;
      else
        return partials + ((int64_t)tile * (mc + 1) + slot) * tile_elems + (int64_t)sm0 * bn +
               sn0;
    };
    for (int sm0 = 0; sm0 < bm; sm0 += SM) {
      for (int sn0 = 0; sn0 < bn; sn0 += kSN) {
        const int row0 = tile_m * bm + sm0;
        const int col0 = tile_n * bn + sn0;
        if constexpr (uses_mma<TA>()) {
          float frag[mma_mt<SM>()][2][4];
          mma_subblock<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, aligned, frag,
                                   smem_raw);
          if (whole)
            store_subblock_mma<SM>(c, epi, frag, m, row0, col0, n);
          else
            park_subblock_mma<SM>(frag, out(sm0, sn0), bn);
        } else if constexpr (std::is_same<TA, int8_t>::value) {
          float frag[mma_mt<SM>()][2][4];
          mma_s8_subblock<P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, bk, aligned, frag,
                                  smem_raw);
          if (whole)
            store_subblock_mma<SM>(c, epi, frag, m, row0, col0, n);
          else
            park_subblock_mma<SM>(frag, out(sm0, sn0), bn);
        } else if constexpr (kOrdered) {
          float acc[SM / 2];
          fma_subblock<TB, P4, SM, true>(a, b, m, n, k, row0, col0, kbeg, kend, aligned, acc,
                                         smem_raw);
          park_subblock_ordered<SM>(acc, out(sm0, sn0), bn);
        } else {
          float acc[SM][fma_tn<SM>()];
          fma_subblock<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg, kend, aligned, acc,
                                   smem_raw);
          if (whole)
            store_subblock_fma<SM>(c, epi, acc, m, row0, col0, n);
          else
            park_subblock_fma<SM>(acc, out(sm0, sn0), bn);
        }
      }
    }
    const int64_t base = (int64_t)tile * (mc + 1) - first_wg;  // slot of contributor w: base + w
    if (!whole) {
      // the last of the tile's contributors to arrive finishes it
      fix_up_split_tile<TOut>(
          counters, tile, first_wg, last_wg, [&](int w) { return base + w; }, partials,
          tile_elems, c, epi, tile_m * bm, m, tile_n * bn, n, bm, bn, last_arrival);
    } else if constexpr (kOrdered) {
      __syncthreads();  // the block's parked slot 0 is complete
      flush_slots<TOut>(x, x, [&](int w) { return base + w; }, partials, tile_elems, c, epi,
                        tile_m * bm, m, tile_n * bn, n, bm, bn);
      __syncthreads();  // the slot is free for the block's next whole tile
    }
    it = seg_end;
  }
}

template <typename TA, typename TB, bool P4, typename TOut>
int launch_dp(int sm, const void* a, const void* b, void* c, int m, int n, int k, int bm, int bn,
              int bk, int n_tiles_n, int tile_offset, int n_total, int grid, bool aligned,
              Epilogue epi, cudaStream_t stream) {
  const TA* ap = static_cast<const TA*>(a);
  const TB* bp = static_cast<const TB*>(b);
  TOut* cp = static_cast<TOut*>(c);
#define SK_DP(S)                                                                                 \
  if constexpr (uses_mma<TA>())                                                                  \
    return launch<dp_mma_kernel<TB, P4, TOut, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid,    \
                                                  stream, ap, bp, cp, m, n, k, bm, bn, n_tiles_n, \
                                                  tile_offset, n_total, aligned, epi);           \
  else if constexpr (std::is_same<TA, int8_t>::value)                                            \
    return launch<dp_s8_kernel<P4, TOut, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid, stream, \
                                             ap, bp, cp, m, n, k, bm, bn, bk, n_tiles_n,         \
                                             tile_offset, n_total, aligned, epi);                \
  else                                                                                           \
    return launch<dp_fma_kernel<TB, P4, TOut, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid,    \
                                                  stream, ap, bp, cp, m, n, k, bm, bn, n_tiles_n, \
                                                  tile_offset, n_total, aligned, epi)
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

// B2 for one operand pair, either output type (0 = float32, 1 = bfloat16):
// one launch that writes C's Stream-K tiles.
template <typename TA, typename TB, bool P4, typename TOut>
int launch_streamk(int sm, const void* a, const void* b, void* c, void* partials,
                   void* counters, int m, int n, int k, int bm, int bn, int bk, int n_tiles_n,
                   int ipt, int ipw, int total, int mc, int grid, bool aligned, Epilogue epi,
                   cudaStream_t stream) {
  const TA* ap = static_cast<const TA*>(a);
  const TB* bp = static_cast<const TB*>(b);
  TOut* cp = static_cast<TOut*>(c);
  float* p = static_cast<float*>(partials);
  int* cnt = static_cast<int*>(counters);
#define SK_P1(S)                                                                               \
  return launch<streamk_kernel<TA, TB, P4, TOut, S>>(mainloop_smem_bytes<TA, TB, P4, S>(), grid, \
                                                     stream, ap, bp, cp, p, cnt, m, n, k, bm, bn, \
                                                     bk, n_tiles_n, ipt, ipw, total, mc, aligned, \
                                                     epi)
  switch (sm) {
    case 8: SK_P1(8);
    case 16: SK_P1(16);
    case 32: SK_P1(32);
    case 64: SK_P1(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SK_P1
}

template <typename TA, typename TB, bool P4>
int streamk_entry(int out_dt, int sm, const void* a, const void* b, void* c, void* partials,
                  void* counters, int m, int n, int k, int bm, int bn, int bk, int n_tiles_n,
                  int ipt, int ipw, int total, int mc, int grid, int aligned, const void* bias,
                  const void* operand, const void* scale, const void* scale_a, int act,
                  int binary, void* stream) {
  const Epilogue epi{bias, operand, static_cast<const float*>(scale),
                     static_cast<const float*>(scale_a), act, binary};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dt == 0)
    return launch_streamk<TA, TB, P4, float>(sm, a, b, c, partials, counters, m, n, k, bm, bn,
                                             bk, n_tiles_n, ipt, ipw, total, mc, grid,
                                             aligned != 0, epi, s);
  if (out_dt == 1)
    return launch_streamk<TA, TB, P4, __nv_bfloat16>(sm, a, b, c, partials, counters, m, n, k,
                                                     bm, bn, bk, n_tiles_n, ipt, ipw, total, mc,
                                                     grid, aligned != 0, epi, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
