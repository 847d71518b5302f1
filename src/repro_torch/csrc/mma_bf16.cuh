// The tensor-core mainloop of B1, B2, B5 and B6 for bf16 activations
// (NVIDIA Hopper, sm_90a): stream_k.cuh, grouped.cuh and splitk.cuh take
// mma_subblock in place of sk_common.cuh's SIMT mac_subblock when A is bf16
// (uses_mma), whatever B is: bf16 (the dense rung), int8 or packed int4 (the
// int8 and int4 rungs). int8 activations run the s8 loop of mma_s8.cuh,
// which reuses the helpers here; f32 activations keep the SIMT loop. The
// helpers at the end flush the fragments through the epilogue (B1, B5; B6's
// partials with an empty one) or park them in an f32 partial slot (B2, B5's
// split tiles); mma_s8.cuh sizes the launch of either loop.
//
// Contract (that of mac_subblock): the f32 sums over [kbeg, kend) of one
// SM x 128 sub-block of A @ B, with ragged M, N and K masked by the loads,
// zeros for a sub-block outside C, and kbeg a multiple of the tile's bk.
//
// What bounded the SIMT loop at the MoE decode shapes (4 tokens, 8-row
// sub-blocks, 128 columns) was its thread map: 8 row groups x 32 column
// groups, so all 8 row groups read and widened the same B elements, 8
// shared-memory reads and 8 conversions per weight, and for int8 weights 8
// I2F per weight at 16 per SM per clock. Here:
//
//   * The MAC is mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by
//     ldmatrix. The 8 warps split the sub-block's 128 columns, 16 each (two
//     n8 tiles), and each warp covers all SM rows in m16 tiles; so every B
//     element is read from shared memory once per block. At SM = 8 the upper
//     8 rows of the m16 tile are zero registers, not staged rows.
//   * int8 and packed int4 B are widened once per block: after a chunk lands
//     each warp converts its own 16-column strip of it into a bf16 chunk in
//     shared memory (warp-local, so a __syncwarp orders it), which ldmatrix
//     then reads as in the dense case. int8 and int4 values are exact in bf16,
//     so every product is the one repro's mixed_dot forms from the integer
//     weight; the per-column scale still applies in the epilogue. The
//     conversion is a byte permute into the mantissa of 2^23, one float
//     subtraction and a permute of the upper halves, not an I2F.
//   * A chunk stages 16 KB of B whatever its type (64 k of bf16, 128 of
//     int8, 256 of packed int4), so each pass of the loop (one barrier, one
//     widening, the MMAs) moves as many bytes on every rung; and the ring of
//     6 slots keeps 64 KB of B in flight per block (one block per SM at the
//     decode tile), where the SIMT ring keeps 16-32 KB, as far as the 227 KB
//     an SM offers allows (5 slots for int8 and 3 for int4 at SM = 64).
//   * Every staged row is padded by 16 bytes, so the 8 row addresses of an
//     ldmatrix (and of the widening's 16-byte accesses) fall in 8 different
//     bank groups; 16-byte cp.async alignment is kept. The element-wise path
//     for rows that are not 16-byte aligned writes the same padded layout.
//
// Accumulators stay in the mma C-fragment layout: thread (warp, lane) holds
// acc[i][j][e] at sub-block row mma_row(i, e), column mma_col(j, e); rows at
// or past SM (the zero half of SM = 8's m16 tile) belong to no output.

#pragma once

#include "sk_common.cuh"

namespace {

constexpr int kMChunkBytes = 16 * 1024;  // bytes of B one K chunk stages
constexpr int kMStrideB = kSN + 8;    // staged or widened bf16 B row: 128 + 8 elements
constexpr int kMInFlight = 64 * 1024;  // bytes of B the ring keeps in flight
constexpr int kMSmemBudget = 232448 - 1024;  // dynamic shared memory: 227 KB, less static

// m16 tiles a warp covers: SM = 8 uses the upper half of one tile as zeros.
template <int SM>
__host__ __device__ constexpr int mma_mt() { return SM < 16 ? 1 : SM / 16; }

// The K depth of one chunk: kMChunkBytes of B whatever its type, so each
// pass of the loop (one barrier, one widening, the MMAs) moves as many bytes
// for int8 and int4 as for bf16: 64 k of bf16, 128 of int8, 256 of int4.
template <typename TB, bool P4>
__host__ __device__ constexpr int mma_kc() {
  return (P4 ? 2 : 1) * kMChunkBytes / (kSN * (int)sizeof(TB));
}
// staged A row: the chunk's k in bf16, plus 16 bytes of padding
template <typename TB, bool P4>
__host__ __device__ constexpr int mma_stride_a() { return mma_kc<TB, P4>() + 8; }
template <typename TB, bool P4>
__host__ __device__ constexpr int mma_b_rows() {
  return P4 ? mma_kc<TB, P4>() / 2 : mma_kc<TB, P4>();
}
template <typename TB>
__host__ __device__ constexpr int mma_b_row_bytes() { return kSN * (int)sizeof(TB) + 16; }
template <typename TB, bool P4, int SM>
__host__ __device__ constexpr int mma_a_slot_bytes() { return SM * mma_stride_a<TB, P4>() * 2; }
template <typename TB, bool P4>
__host__ __device__ constexpr int mma_b_slot_bytes() {
  return mma_b_rows<TB, P4>() * mma_b_row_bytes<TB>();
}
template <typename TB>
__host__ __device__ constexpr bool mma_widens() { return !std::is_same<TB, __nv_bfloat16>::value; }
template <typename TB, bool P4>
__host__ __device__ constexpr int mma_cvt_bytes() {
  return mma_widens<TB>() ? mma_kc<TB, P4>() * kMStrideB * 2 : 0;
}

// Ring slots: enough that kMInFlight bytes of B are in flight while the
// block multiplies the oldest chunk, as far as shared memory allows.
template <typename TB, bool P4, int SM>
__host__ __device__ constexpr int mma_stages() {
  constexpr int want = 2 + kMInFlight / kMChunkBytes;
  constexpr int fit = (kMSmemBudget - mma_cvt_bytes<TB, P4>()) /
                      (mma_a_slot_bytes<TB, P4, SM>() + mma_b_slot_bytes<TB, P4>());
  static_assert(fit >= 3, "the ring does not fit in shared memory");
  return want < fit ? want : fit;
}

template <typename TB, bool P4, int SM>
__host__ __device__ constexpr int mma_smem_bytes() {
  return mma_stages<TB, P4, SM>() *
             (mma_a_slot_bytes<TB, P4, SM>() + mma_b_slot_bytes<TB, P4>()) +
         mma_cvt_bytes<TB, P4>();
}

// The sub-block row and column of this thread's accumulator acc[i][j][e]:
// mma's C fragment holds rows gid and gid + 8 of m16 tile i and columns
// 2 * tig, 2 * tig + 1 of n8 tile j of the warp's 16 columns.
__device__ __forceinline__ int mma_row(int i, int e) {
  return i * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int mma_col(int j, int e) {
  return (threadIdx.x >> 5) * 16 + j * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four biased bytes (each 0..255, the value plus `bias`) -> four bf16,
// exactly: a byte permute makes the float 2^23 + byte, the subtraction of
// 2^23 + bias leaves the signed value, and its bf16 is the float's upper half
// (|value| <= 128 needs 8 significant bits, so nothing is cut).
__device__ __forceinline__ uint2 biased_bytes_to_bf16(unsigned u, float bias) {
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | j)) - (8388608.f + bias);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}
// Four int8 weights (one word, in column order) -> four bf16.
__device__ __forceinline__ uint2 i8x4_to_bf16(unsigned w) {
  return biased_bytes_to_bf16(w ^ 0x80808080u, 128.f);
}
// Four packed int4 bytes -> the even k row's four bf16 (low nibbles) and the
// odd k row's (high nibbles), sign-extended as unpack4 does: nibble ^ 8 is
// the signed value plus 8.
__device__ __forceinline__ void i4x4_to_bf16(unsigned w, uint2& lo, uint2& hi) {
  const unsigned u = w ^ 0x88888888u;
  lo = biased_bytes_to_bf16(u & 0x0F0F0F0Fu, 8.f);
  hi = biased_bytes_to_bf16((u >> 4) & 0x0F0F0F0Fu, 8.f);
}

// Widen this warp's 16 columns of one staged int8 or packed int4 chunk into
// the bf16 chunk `cvt` (mma_kc rows of kMStrideB): 16 bytes of each staged
// row, one row per lane at a time.
template <bool P4>
__device__ __forceinline__ void widen_strip(const int8_t* raw, __nv_bfloat16* cvt) {
  constexpr int RAW = mma_b_row_bytes<int8_t>();
  constexpr int ROWS = mma_b_rows<int8_t, P4>();
  const int lane = threadIdx.x & 31;
  const int c0 = (threadIdx.x >> 5) * 16;
  if constexpr (P4) {  // packed row r holds k rows 2r and 2r + 1
#pragma unroll
    for (int r = lane; r < ROWS; r += 32) {
      const uint4 q = *reinterpret_cast<const uint4*>(raw + r * RAW + c0);
      uint2 lo[4], hi[4];
      i4x4_to_bf16(q.x, lo[0], hi[0]);
      i4x4_to_bf16(q.y, lo[1], hi[1]);
      i4x4_to_bf16(q.z, lo[2], hi[2]);
      i4x4_to_bf16(q.w, lo[3], hi[3]);
      uint4* even = reinterpret_cast<uint4*>(cvt + (2 * r) * kMStrideB + c0);
      uint4* odd = reinterpret_cast<uint4*>(cvt + (2 * r + 1) * kMStrideB + c0);
      even[0] = make_uint4(lo[0].x, lo[0].y, lo[1].x, lo[1].y);
      even[1] = make_uint4(lo[2].x, lo[2].y, lo[3].x, lo[3].y);
      odd[0] = make_uint4(hi[0].x, hi[0].y, hi[1].x, hi[1].y);
      odd[1] = make_uint4(hi[2].x, hi[2].y, hi[3].x, hi[3].y);
    }
  } else {
#pragma unroll
    for (int r = lane; r < ROWS; r += 32) {
      const uint4 q = *reinterpret_cast<const uint4*>(raw + r * RAW + c0);
      const uint2 v0 = i8x4_to_bf16(q.x), v1 = i8x4_to_bf16(q.y);
      const uint2 v2 = i8x4_to_bf16(q.z), v3 = i8x4_to_bf16(q.w);
      uint4* dst = reinterpret_cast<uint4*>(cvt + r * kMStrideB + c0);
      dst[0] = make_uint4(v0.x, v0.y, v1.x, v1.y);
      dst[1] = make_uint4(v2.x, v2.y, v3.x, v3.y);
    }
  }
}

// Copy one K chunk [k0, k0 + KC) of the sub-block's A rows and B columns
// into ring slot `as`/`bs`, in the padded layout. As load_chunk: 16-byte
// cp.async when aligned (zero-filling past M, N and kend), else element by
// element; packed int4 B is rows [k0 / 2, k0 / 2 + KC / 2) masked against
// ceil(kend / 2).
template <typename TB, bool P4, int SM>
__device__ __forceinline__ void mma_load_chunk(const __nv_bfloat16* __restrict__ a,
                                               const TB* __restrict__ b, int m, int n, int k,
                                               int row0, int col0, int k0, int kend, bool aligned,
                                               __nv_bfloat16* as, TB* bs) {
  constexpr int KC = mma_kc<TB, P4>();
  constexpr int A_STRIDE = mma_stride_a<TB, P4>();
  constexpr int A_VECS = SM * KC / 8;
  constexpr int VB = 16 / (int)sizeof(TB);
  constexpr int B_STRIDE = mma_b_row_bytes<TB>() / (int)sizeof(TB);
  constexpr int B_VECS = mma_b_rows<TB, P4>() * kSN / VB;
  const int t = threadIdx.x;
  for (int e = t; e < A_VECS; e += kThreads) {
    const int r = e / (KC / 8);
    const int kk = (e % (KC / 8)) * 8;
    const int gr = row0 + r;
    const int gk = k0 + kk;
    const int valid = gr < m ? min(max(kend - gk, 0), 8) : 0;
    const __nv_bfloat16* src = a + (int64_t)gr * k + gk;
    __nv_bfloat16* dst = as + r * A_STRIDE + kk;
    if (aligned) {
      cp_async16(dst, valid ? src : a, valid * 2);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = j < valid ? src[j] : zero_of<__nv_bfloat16>();
    }
  }
  const int r0 = P4 ? k0 / 2 : k0;
  const int rend = P4 ? (kend + 1) / 2 : kend;
  for (int e = t; e < B_VECS; e += kThreads) {
    const int r = e / (kSN / VB);
    const int c = (e % (kSN / VB)) * VB;
    const int gk = r0 + r;
    const int gc = col0 + c;
    const int valid = gk < rend ? min(max(n - gc, 0), VB) : 0;
    const TB* src = b + (int64_t)gk * n + gc;
    TB* dst = bs + r * B_STRIDE + c;
    if (aligned) {
      cp_async16(dst, valid ? src : b, valid * (int)sizeof(TB));
    } else {
#pragma unroll
      for (int j = 0; j < VB; ++j) dst[j] = j < valid ? src[j] : zero_of<TB>();
    }
  }
}

// acc = the sums over [kbeg, kend) of the SM x 128 sub-block at (row0, col0)
// of A (bf16) @ B (bf16, int8, or packed int4 when P4), in the C-fragment
// layout. S - 1 chunks are in flight while the block multiplies the oldest.
template <typename TB, bool P4, int SM>
__device__ __forceinline__ void mma_subblock(const __nv_bfloat16* __restrict__ a,
                                             const TB* __restrict__ b, int m, int n, int k,
                                             int row0, int col0, int kbeg, int kend, bool aligned,
                                             float (&acc)[mma_mt<SM>()][2][4],
                                             unsigned char* smem) {
  constexpr int MT = mma_mt<SM>();
  constexpr int KC = mma_kc<TB, P4>();
  constexpr int A_STRIDE = mma_stride_a<TB, P4>();
  constexpr int S = mma_stages<TB, P4, SM>();
  constexpr int A_SLOT = mma_a_slot_bytes<TB, P4, SM>();
  constexpr int B_SLOT = mma_b_slot_bytes<TB, P4>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  if (row0 >= m || col0 >= n) return;  // uniform across the block

  unsigned char* ring_b = smem + S * A_SLOT;
  __nv_bfloat16* cvt = reinterpret_cast<__nv_bfloat16*>(smem + S * (A_SLOT + B_SLOT));
  const int lane = threadIdx.x & 31;
  // this lane's ldmatrix row address within a staged chunk (elements): A's
  // m16 x k16 tile as 4 (x2 at SM = 8: 2) 8 x 8 matrices, B's k16 x n16
  // strip of the warp as 4 transposed ones (b0, b1 of n8 tile 0, then 1)
  const int a_off = SM < 16 ? (lane & 7) * A_STRIDE + ((lane >> 3) & 1) * 8
                            : (lane & 15) * A_STRIDE + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kMStrideB +
                    (threadIdx.x >> 5) * 16 + (lane >> 4) * 8;
  const int nchunks = (kend - kbeg + KC - 1) / KC;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nchunks)
      mma_load_chunk<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg + st * KC, kend, aligned,
                                 reinterpret_cast<__nv_bfloat16*>(smem + st * A_SLOT),
                                 reinterpret_cast<TB*>(ring_b + st * B_SLOT));
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and slot c-1 is free again
    const int next = c + S - 1;
    if (next < nchunks) {
      const int slot = next % S;
      mma_load_chunk<TB, P4, SM>(a, b, m, n, k, row0, col0, kbeg + next * KC, kend, aligned,
                                 reinterpret_cast<__nv_bfloat16*>(smem + slot * A_SLOT),
                                 reinterpret_cast<TB*>(ring_b + slot * B_SLOT));
    }
    cp_async_commit();
    const int slot = c % S;
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(smem + slot * A_SLOT);
    const __nv_bfloat16* b_s;
    if constexpr (mma_widens<TB>()) {
      __syncwarp();  // the warp's reads of the previous widened chunk are done
      widen_strip<P4>(reinterpret_cast<const int8_t*>(ring_b + slot * B_SLOT), cvt);
      __syncwarp();
      b_s = cvt;
    } else {
      b_s = reinterpret_cast<const __nv_bfloat16*>(ring_b + slot * B_SLOT);
    }
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      unsigned bf[4];
      ldmatrix_x4_trans(bf, b_s + b_off + ks * 16 * kMStrideB);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned af[4];
        if constexpr (SM < 16) {
          unsigned lo[2];
          ldmatrix_x2(lo, a_s + a_off + ks * 16);
          af[0] = lo[0];
          af[1] = 0u;  // rows 8-15 of the m16 tile: zeros
          af[2] = lo[1];
          af[3] = 0u;
        } else {
          ldmatrix_x4(af, a_s + a_off + i * 16 * A_STRIDE + ks * 16);
        }
        mma_16816(acc[i][0], af, bf[0], bf[1]);
        mma_16816(acc[i][1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the next sub-block refills the ring
}

// The tensor-core mainloop takes bf16 activations.
template <typename TA>
__host__ __device__ constexpr bool uses_mma() {
  return std::is_same<TA, __nv_bfloat16>::value;
}

// Flush one multiplied sub-block, in the C-fragment layout, through the
// epilogue into the row-major C (n columns); rows at or past row_end are
// left alone.
template <int SM, typename TOut>
__device__ __forceinline__ void store_subblock_mma(TOut* __restrict__ c, const Epilogue& epi,
                                                   const float (&acc)[mma_mt<SM>()][2][4],
                                                   int row_end, int row0, int col0, int n) {
#pragma unroll
  for (int i = 0; i < mma_mt<SM>(); ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mma_row(i, e);
        const int64_t row = row0 + r;
        const int col = col0 + mma_col(j, e);
        if (r < SM && row < row_end && col < n)
          c[row * n + col] = from_f32<TOut>(apply_epilogue<TOut>(acc[i][j][e], epi, row, col, n));
      }
}

// Park one sub-block's fragment accumulators in an f32 partial slot: rows
// r < SM of the sub-block, all 128 columns (`dst` is the sub-block's corner
// in the row-major bm x bn slot).
template <int SM>
__device__ __forceinline__ void park_subblock_mma(const float (&acc)[mma_mt<SM>()][2][4],
                                                  float* dst, int bn) {
#pragma unroll
  for (int i = 0; i < mma_mt<SM>(); ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mma_row(i, 2 * h);
        if (r < SM)
          *reinterpret_cast<float2*>(dst + (int64_t)r * bn + mma_col(j, 0)) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

}  // namespace
