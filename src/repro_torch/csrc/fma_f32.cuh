// The f32 FMA mainloop of B1, B2, B5 and B6 for f32 activations (NVIDIA
// Hopper, sm_90a): stream_k.cuh's dp_fma_kernel and streamk_kernel,
// grouped.cuh's grouped_sk_kernel and grouped_dp_kernel and splitk.cuh's
// splitk_fma_kernel run fma_subblock when A is f32, whatever B is: f32 (the
// dense pair), int8 or packed int4 (the f32 x int8 and f32 x int4 pairs of
// the ladder). No TF32: every product is one f32 FMA of the f32 activation and the exact f32 value
// of the weight, as repro's mixed_dot forms it (1e-4, docs/kernels.md).
//
// Contract (sk_common.cuh's): the f32 sums over [kbeg, kend) of one
// SM x 128 sub-block of A @ B, with ragged M, N and K masked by the loads,
// zeros for a sub-block outside C, and kbeg a multiple of the tile's bk;
// operands whose rows are not 16-byte aligned fill the same ring element by
// element.
//
// What bounded the SIMT loop at the decode sub-block (SM = 8, M = 4) was its
// thread map: 8 row groups x 32 column groups, so all 8 warps read every
// weight of a chunk from shared memory, and widened each int8 or int4 one to
// f32 by an I2F, 8 times per block (470 M I2F for B6's 4 x 14336 x 4096 f32
// x int8, about 0.12 ms at 16 per SM per clock); and the ring, sized in
// 32-deep chunks, kept only 16 or 8 KB of int8 or int4 B in flight. Here:
//
//   * The 8 warps split the sub-block's 128 columns, 16 each, as in the mma
//     loops. Within a warp a lane owns TN adjacent columns (TN = 4, or 2 at
//     SM = 64 to keep SM x TN sums in registers) and one of KS = 2 * TN
//     K slices: of every 4 * KS consecutive k the lane takes the quad
//     [4 s, 4 s + 4). So every B element is read from shared memory, and
//     widened, by one thread once per block, and each A row is a broadcast:
//     the KS slices of a warp read KS adjacent 16-byte quads of it.
//   * The lane keeps all SM rows of its TN columns, over its K slice. At the
//     end of the sub-block the KS slices are summed by a fixed tree of warp
//     shuffles that also spreads the rows: lane s ends with rows s, s + KS,
//     ... (fma_row). The order is fixed, so the sums are bit-identical from
//     run to run; it is not the SIMT loop's order (1e-4 against the plain
//     version). Dense f32 B2 (olmoe's router) takes the k-ordered map
//     instead (ORDERED, ord_chunk): a thread owns one column and every
//     other row and sums each over k in order, one FMA per k, the SIMT
//     loop's order and bits; its weights, read by two threads, need no
//     widening.
//   * A sub-block whose rows lie at most half inside C (M = 4 in SM = 8,
//     the decode shape) multiplies only that half: the other rows are
//     zeros, and their FMAs were half the loop's work there.
//   * int8 and packed int4 weights are widened in registers as they are
//     read: a byte permute into the mantissa of 2^23 and one float
//     subtraction (mma_bf16.cuh's trick, kept in f32), exact for int8 and
//     sign-extended int4, with no I2F.
//   * A chunk stages 16 KB of B whatever its type (mma_kc: 32 k of f32, 128
//     of int8, 256 of packed int4), and the ring keeps up to 64 KB of B in
//     flight: fma_stages, as far as the chunk's f32 A rows let the ring fit
//     in 227 KB (2 slots for int4 at SM = 64, where one A slot is 64 KB).
//   * Staged B rows are not padded: the 16-byte segments of a row are
//     XOR-swizzled by the row's k quad (fma_seg), so the lanes of one load,
//     which read rows 4 apart, hit different banks: for f32 the segment
//     index flips bit 2 on odd quads (a half-row, 16 banks, further), for
//     int8 and int4 it is XORed with the quad mod 8 (each of the 8 slices'
//     rows in its own 4 banks). A rows are read one row at a time by the
//     whole warp and need no swizzle. The element-wise path writes the same
//     layout.
//
// What bounds it on the H100 (80GB HBM3 at 700 W, kernel_ab.py, M = 4): B5's
// DP form at 64x4x1024x2048 (8x256x128, g = 132) takes 0.181 ms on f32
// weights against a byte bound of 0.161 (the SIMT loop: 0.312), bound by
// bytes; 0.078 and 0.064 ms on int8 and int4 (SIMT 0.351 and 0.254, byte
// bounds 0.041 and 0.021), and B6 at 4x14336x4096 (s = 4, 8x128x128) 0.084 /
// 0.034 / 0.033 ms on f32 / int8 / int4 (SIMT 0.108 / 0.152 / 0.103, byte
// bounds 0.070 / 0.018 / 0.009): on the narrow weights each 16 KB chunk's
// FMAs, widening and barrier, not its bytes, set the pace.
//
// After the reduction, thread (warp, lane) holds acc[r][j] at sub-block row
// fma_row(r) and column fma_col(j); store_subblock_fma flushes it through
// the epilogue (B1, B6, and the whole tiles of B2 and both B5 forms),
// park_subblock_fma parks it in an f32 partial slot (the segments of B2's
// and B5's split tiles). The k-ordered map parks with park_subblock_ordered,
// whole tiles too (stream_k.cuh flushes their one slot).

#pragma once

#include "mma_bf16.cuh"

namespace {

constexpr int kFInFlight = 64 * 1024;  // bytes of B the ring keeps in flight

// Columns a lane owns, and the K slices of a warp: 16 / TN column groups of
// TN columns, 32 / (16 / TN) = 2 * TN slices.
template <int SM>
__host__ __device__ constexpr int fma_tn() { return SM >= 64 ? 2 : 4; }
template <int SM>
__host__ __device__ constexpr int fma_ks() { return 2 * fma_tn<SM>(); }
// rows of a lane after the reduction
template <int SM>
__host__ __device__ constexpr int fma_rows() { return SM / fma_ks<SM>(); }

template <typename TB, bool P4, int SM>
__host__ __device__ constexpr int fma_a_slot_bytes() { return SM * mma_kc<TB, P4>() * 4; }

// Ring slots: enough that kFInFlight bytes of B are in flight while the
// block multiplies the oldest chunk, as far as shared memory allows.
template <typename TB, bool P4, int SM>
__host__ __device__ constexpr int fma_stages() {
  constexpr int want = 1 + kFInFlight / kMChunkBytes;
  constexpr int fit = kMSmemBudget / (fma_a_slot_bytes<TB, P4, SM>() + kMChunkBytes);
  static_assert(fit >= 2, "the ring does not fit in shared memory");
  return want < fit ? want : fit;
}

// Dynamic shared memory of one block that runs fma_subblock.
template <typename TB, bool P4, int SM>
__host__ __device__ constexpr int fma_smem_bytes() {
  return fma_stages<TB, P4, SM>() * (fma_a_slot_bytes<TB, P4, SM>() + kMChunkBytes);
}

// The physical 16-byte segment of segment g of a staged B row whose k quad
// is q (its first k over 4; a packed int4 row 2r holds k 2r and 2r + 1).
template <typename TB>
__device__ __forceinline__ int fma_seg(int g, int q) {
  return std::is_same<TB, float>::value ? g ^ ((q & 1) << 2) : g ^ (q & 7);
}

// The sub-block row and column of this thread's reduced acc[r][j].
template <int SM>
__device__ __forceinline__ int fma_row(int r) {
  return r * fma_ks<SM>() + (threadIdx.x & 31) / (16 / fma_tn<SM>());
}
template <int SM>
__device__ __forceinline__ int fma_col(int j) {
  constexpr int TN = fma_tn<SM>();
  return (threadIdx.x >> 5) * 16 + TN * ((threadIdx.x & 31) % (16 / TN)) + j;
}

// Copy one K chunk [k0, k0 + KC) of the sub-block's A rows (f32, SM rows of
// KC) and B columns into ring slot `as`/`bs`, B in the swizzled layout. As
// load_chunk: 16-byte cp.async when aligned (zero-filling past M, N and
// kend), else element by element; packed int4 B is rows [k0 / 2, k0 / 2 +
// KC / 2) masked against ceil(kend / 2).
template <typename TB, bool P4, int SM>
__device__ __forceinline__ void fma_load_chunk(const float* __restrict__ a,
                                               const TB* __restrict__ b, int m, int n, int k,
                                               int row0, int col0, int k0, int kend, bool aligned,
                                               float* as, unsigned char* bs) {
  constexpr int KC = mma_kc<TB, P4>();
  constexpr int A_VECS = SM * KC / 4;
  constexpr int VB = 16 / (int)sizeof(TB);
  constexpr int ROW = kSN * (int)sizeof(TB);  // bytes of a staged B row
  constexpr int B_VECS = mma_b_rows<TB, P4>() * kSN / VB;
  const int t = threadIdx.x;
  for (int e = t; e < A_VECS; e += kThreads) {
    const int r = e / (KC / 4);
    const int kk = (e % (KC / 4)) * 4;
    const int gr = row0 + r;
    const int gk = k0 + kk;
    const int valid = gr < m ? min(max(kend - gk, 0), 4) : 0;
    const float* src = a + (int64_t)gr * k + gk;
    float* dst = as + r * KC + kk;
    if (aligned) {
      cp_async16(dst, valid ? src : a, valid * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = j < valid ? src[j] : 0.f;
    }
  }
  const int r0 = P4 ? k0 / 2 : k0;
  const int rend = P4 ? (kend + 1) / 2 : kend;
  for (int e = t; e < B_VECS; e += kThreads) {
    const int r = e / (kSN / VB);
    const int g = e % (kSN / VB);
    const int gk = r0 + r;
    const int gc = col0 + g * VB;
    const int valid = gk < rend ? min(max(n - gc, 0), VB) : 0;
    const TB* src = b + (int64_t)gk * n + gc;
    TB* dst = reinterpret_cast<TB*>(bs + r * ROW + fma_seg<TB>(g, (P4 ? 2 * r : r) >> 2) * 16);
    if (aligned) {
      cp_async16(dst, valid ? src : b, valid * (int)sizeof(TB));
    } else {
#pragma unroll
      for (int j = 0; j < VB; ++j) dst[j] = j < valid ? src[j] : zero_of<TB>();
    }
  }
}

// Byte j of u, taken as the biased value (0..255) of a weight, as an exact
// f32: the float 2^23 + byte, less 2^23 + bias.
__device__ __forceinline__ float biased_byte_to_f32(unsigned u, int j, float bias) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | j)) - (8388608.f + bias);
}

// This lane's TN columns of the 4 k rows [kq0, kq0 + 4) of a staged B
// chunk, widened to f32: bv[kk][j] is row kq0 + kk, column j of the lane's.
// `byte0` is the lane's first column in bytes of a staged row.
template <typename TB, bool P4, int TN>
__device__ __forceinline__ void fma_load_b(const unsigned char* b_s, int kq0, int byte0,
                                           float (&bv)[4][TN]) {
  constexpr int ROW = kSN * (int)sizeof(TB);
  const int col = fma_seg<TB>(byte0 >> 4, kq0 >> 2) * 16 + (byte0 & 15);
  if constexpr (std::is_same<TB, float>::value) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned char* p = b_s + (kq0 + kk) * ROW + col;
      if constexpr (TN == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        bv[kk][0] = q.x; bv[kk][1] = q.y; bv[kk][2] = q.z; bv[kk][3] = q.w;
      } else {
        const float2 q = *reinterpret_cast<const float2*>(p);
        bv[kk][0] = q.x; bv[kk][1] = q.y;
      }
    }
  } else if constexpr (!P4) {
    // int8: value ^ 0x80 is the value plus 128
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned char* p = b_s + (kq0 + kk) * ROW + col;
      const unsigned u = (TN == 4 ? *reinterpret_cast<const unsigned*>(p)
                                  : *reinterpret_cast<const unsigned short*>(p)) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[kk][j] = biased_byte_to_f32(u, j, 128.f);
    }
  } else {
    // packed int4: packed row kq0 / 2 + h holds k rows kq0 + 2h (low
    // nibbles) and kq0 + 2h + 1 (high); nibble ^ 8 is the value plus 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* p = b_s + (kq0 / 2 + h) * ROW + col;
      const unsigned u = (TN == 4 ? *reinterpret_cast<const unsigned*>(p)
                                  : *reinterpret_cast<const unsigned short*>(p)) ^ 0x88888888u;
      const unsigned lo = u & 0x0F0F0F0Fu;
      const unsigned hi = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bv[2 * h][j] = biased_byte_to_f32(lo, j, 8.f);
        bv[2 * h + 1][j] = biased_byte_to_f32(hi, j, 8.f);
      }
    }
  }
}

// One staged chunk into this lane's sums: for each of its k quads, the TN
// weights of 4 k rows, then each of the first ROWS A rows' quad (one
// 16-byte broadcast load) times them, k in ascending order. Rows at or past
// ROWS are all past M (zeros): their sums stay 0.
template <typename TB, bool P4, int SM, int ROWS>
__device__ __forceinline__ void fma_chunk(const float* a_s, const unsigned char* b_s,
                                          float (&acc)[SM][fma_tn<SM>()]) {
  constexpr int TN = fma_tn<SM>();
  constexpr int KC = mma_kc<TB, P4>();
  constexpr int STEP = 4 * fma_ks<SM>();  // k of one pass over the K slices
  const int lane = threadIdx.x & 31;
  const int s = lane / (16 / TN);
  const int byte0 = fma_col<SM>(0) * (int)sizeof(TB);
#pragma unroll 2
  for (int st = 0; st < KC / STEP; ++st) {
    const int kq0 = st * STEP + 4 * s;
    float bv[4][TN];
    fma_load_b<TB, P4, TN>(b_s, kq0, byte0, bv);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a_s + i * KC + kq0);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(av.x, bv[0][j], acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[1][j], acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[2][j], acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[3][j], acc[i][j]);
      }
    }
  }
}

// The k-ordered map of dense f32 B2 (fma_subblock<float, false, SM, true>):
// thread (warp w, lane l) owns column ord_col = 32 (w % 4) + l and rows
// ord_row(r) = 2 r + w / 4, r < SM / 2, and sums each over k in ascending
// order, one FMA per k: the order of the SIMT loop this replaced, so the
// partials keep that loop's bits. A warp's B reads are 32 adjacent words of
// a staged row and its A reads one broadcast row quad, so neither conflicts.
__device__ __forceinline__ int ord_col() {
  return ((threadIdx.x >> 5) & 3) * 32 + (threadIdx.x & 31);
}
__device__ __forceinline__ int ord_row(int r) { return 2 * r + (threadIdx.x >> 7); }

// One staged f32 chunk into this thread's k-ordered sums; rows at or past
// ROWS are all past M (zeros): their sums stay 0.
template <int SM, int ROWS>
__device__ __forceinline__ void ord_chunk(const float* a_s, const unsigned char* b_s,
                                          float (&acc)[SM / 2]) {
  constexpr int KC = mma_kc<float, false>();
  const int c = ord_col();
  const int h = threadIdx.x >> 7;
  // unrolled: rolled, it read 13 % slower on the H100 and spilled still
#pragma unroll
  for (int kq0 = 0; kq0 < KC; kq0 += 4) {
    const float* bp = reinterpret_cast<const float*>(
        b_s + kq0 * kSN * 4 + fma_seg<float>(c >> 2, kq0 >> 2) * 16) + (c & 3);
    float bv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = bp[kk * kSN];
#pragma unroll
    for (int r = 0; r < ROWS / 2; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(a_s + (2 * r + h) * KC + kq0);
      acc[r] = fmaf(av.x, bv[0], acc[r]);
      acc[r] = fmaf(av.y, bv[1], acc[r]);
      acc[r] = fmaf(av.z, bv[2], acc[r]);
      acc[r] = fmaf(av.w, bv[3], acc[r]);
    }
  }
}

// Sum the KS slices of each column and spread the rows: at level L the
// lanes that differ in bit L of the slice swap halves, each keeping the rows
// whose bit L matches its own (in place, the kept rows packed to the front).
// After the last level acc[r][j], r < fma_rows, is row fma_row(r) summed
// over K.
template <int SM, int L = 0>
__device__ __forceinline__ void fma_reduce(float (&acc)[SM][fma_tn<SM>()]) {
  if constexpr ((1 << L) < fma_ks<SM>()) {
    constexpr int CG = 16 / fma_tn<SM>();
    const bool upper = (((threadIdx.x & 31) / CG) >> L) & 1;
#pragma unroll
    for (int i = 0; i < (SM >> (L + 1)); ++i)
#pragma unroll
      for (int j = 0; j < fma_tn<SM>(); ++j) {
        const float keep = upper ? acc[2 * i + 1][j] : acc[2 * i][j];
        const float give = upper ? acc[2 * i][j] : acc[2 * i + 1][j];
        acc[i][j] = keep + __shfl_xor_sync(0xffffffffu, give, CG << L);
      }
    fma_reduce<SM, L + 1>(acc);
  }
}

// acc = the sums over [kbeg, kend) of the SM x 128 sub-block at (row0, col0)
// of A (f32) @ B (f32, int8, or packed int4 when P4), reduced over the K
// slices: thread's acc[r][j] is row fma_row(r), column fma_col(j). With
// ORDERED (dense f32 only), acc is float[SM / 2] in the k-ordered map:
// acc[r] is row ord_row(r), column ord_col(). S - 1 chunks are in flight
// while the block multiplies the oldest.
template <typename TB, bool P4, int SM, bool ORDERED = false, typename Acc>
__device__ __forceinline__ void fma_subblock(const float* __restrict__ a,
                                             const TB* __restrict__ b, int m, int n, int k,
                                             int row0, int col0, int kbeg, int kend, bool aligned,
                                             Acc& acc, unsigned char* smem) {
  static_assert(!ORDERED || std::is_same<TB, float>::value, "the k-ordered map is dense f32's");
  constexpr int KC = mma_kc<TB, P4>();
  constexpr int S = fma_stages<TB, P4, SM>();
  constexpr int A_SLOT = fma_a_slot_bytes<TB, P4, SM>();
  if constexpr (ORDERED) {
#pragma unroll
    for (int i = 0; i < SM / 2; ++i) acc[i] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < SM; ++i)
#pragma unroll
      for (int j = 0; j < fma_tn<SM>(); ++j) acc[i][j] = 0.f;
  }
  if (row0 >= m || col0 >= n) return;  // uniform across the block

  unsigned char* ring_b = smem + S * A_SLOT;
  const int nchunks = (kend - kbeg + KC - 1) / KC;
  // a sub-block at most half inside C (a decode M of 4 in SM = 8) multiplies
  // only its upper half of rows
  const bool half = m - row0 <= SM / 2;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nchunks)
      fma_load_chunk<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg + st * KC, kend, aligned,
                                 reinterpret_cast<float*>(smem + st * A_SLOT),
                                 ring_b + st * kMChunkBytes);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and slot c-1 is free again
    const int next = c + S - 1;
    if (next < nchunks) {
      const int slot = next % S;
      fma_load_chunk<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg + next * KC, kend, aligned,
                                 reinterpret_cast<float*>(smem + slot * A_SLOT),
                                 ring_b + slot * kMChunkBytes);
    }
    cp_async_commit();
    const int slot = c % S;
    const float* a_s = reinterpret_cast<const float*>(smem + slot * A_SLOT);
    if constexpr (ORDERED) {
      if (half)
        ord_chunk<SM, SM / 2>(a_s, ring_b + slot * kMChunkBytes, acc);
      else
        ord_chunk<SM, SM>(a_s, ring_b + slot * kMChunkBytes, acc);
    } else {
      if (half)
        fma_chunk<TB, P4, SM, SM / 2>(a_s, ring_b + slot * kMChunkBytes, acc);
      else
        fma_chunk<TB, P4, SM, SM>(a_s, ring_b + slot * kMChunkBytes, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the next sub-block refills the ring
  if constexpr (!ORDERED) fma_reduce<SM>(acc);
}

// Flush one reduced sub-block through the epilogue into the row-major C (n
// columns); rows at or past row_end are left alone.
template <int SM, typename TOut>
__device__ __forceinline__ void store_subblock_fma(TOut* __restrict__ c, const Epilogue& epi,
                                                   const float (&acc)[SM][fma_tn<SM>()],
                                                   int row_end, int row0, int col0, int n) {
#pragma unroll
  for (int r = 0; r < fma_rows<SM>(); ++r) {
    const int64_t row = row0 + fma_row<SM>(r);
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < fma_tn<SM>(); ++j) {
      const int col = col0 + fma_col<SM>(j);
      if (col < n)
        c[row * n + col] = from_f32<TOut>(apply_epilogue<TOut>(acc[r][j], epi, row, col, n));
    }
  }
}

// Park one reduced sub-block in an f32 partial slot: all SM rows and 128
// columns of it, zeros outside C included (`dst` is the sub-block's corner
// in the row-major slot, `bn` columns a row), one TN-wide vector store per
// row a thread holds.
template <int SM>
__device__ __forceinline__ void park_subblock_fma(const float (&acc)[SM][fma_tn<SM>()],
                                                  float* dst, int bn) {
#pragma unroll
  for (int r = 0; r < fma_rows<SM>(); ++r) {
    float* p = dst + (int64_t)fma_row<SM>(r) * bn + fma_col<SM>(0);
    if constexpr (fma_tn<SM>() == 4)
      *reinterpret_cast<float4*>(p) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(acc[r][0], acc[r][1]);
  }
}

// Park a k-ordered sub-block (ORDERED fma_subblock) the same way: all SM
// rows and 128 columns, zeros outside C included; a warp stores 32 adjacent
// words of a row.
template <int SM>
__device__ __forceinline__ void park_subblock_ordered(const float (&acc)[SM / 2], float* dst,
                                                      int bn) {
#pragma unroll
  for (int r = 0; r < SM / 2; ++r) dst[(int64_t)ord_row(r) * bn + ord_col()] = acc[r];
}

}  // namespace
