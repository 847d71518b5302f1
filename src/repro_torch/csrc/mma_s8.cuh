// The s8 tensor-core mainloop of B1, B2, B5 and B6 for int8 activations
// (NVIDIA Hopper, sm_90a): stream_k.cuh, grouped.cuh and splitk.cuh take
// mma_s8_subblock when A is int8, whether B is int8 (the int8-dynamic rung) or packed int4 (int8 x
// int4, int4-dynamic). bf16 activations run mma_bf16.cuh, f32 ones
// fma_f32.cuh. mainloop_smem_bytes, at the end, sizes the launch of
// whichever of the three loops a kernel runs.
//
// Contract (sk_common.cuh's, on int8 activations): the f32 sums over
// [kbeg, kend) of one SM x 128 sub-block of A @ B, with ragged M, N and K
// masked by the loads, zeros for a sub-block outside C, and kbeg a multiple
// of bk. Each bk step's exact int32 sum is added into the f32 accumulator at
// the step's end (every absolute k that is a multiple of bk) and at kend, as
// repro's mixed_dot converts each k-step's int32 partial. Every step sum is
// below 2^24 (at most 256 x 127^2), so the conversion is exact, and the f32
// additions run in the order of the SIMT loop this replaced and of the
// plain versions' kstep_dot: the result is theirs, bit for bit, for a whole
// tile and for a Stream-K segment alike.
//
// What bounded the SIMT loop at the MoE decode shapes (4 tokens, 8-row
// sub-blocks) was its thread map: 8 row groups x 32 column groups, so every
// weight was read from shared memory 8 times (and, for int4, unpacked 8
// times), with 4 of the 8 rows empty. Here:
//
//   * The MAC is mma.sync.m16n8k32 (s8 x s8, s32 accumulate), which sums
//     exactly in int32. The 8 warps split the sub-block's 128 columns, 16
//     each (two n8 tiles), each warp covering all SM rows in m16 tiles, as
//     mma_bf16.cuh does: every weight is read from shared memory once per
//     block. The int32 step fragments sit beside the f32 ones in the same
//     C-fragment layout, so mma_bf16.cuh's flush and park serve both.
//   * A (int8 activations) is staged as bf16 rows are: a row of the chunk's
//     KC bytes plus 16 bytes of padding. The s8 m16 x k32 A fragment is, byte
//     for byte, the b16 m16 x k16 one, so ldmatrix.x4 (x2 and zeros at
//     SM = 8) loads it at the bf16 path's offsets counted in bytes.
//   * B keeps its layout, (K, N) int8 or (ceil(K/2), N) packed int4, and a
//     chunk stages 16 KB of it whatever its type: KC = 128 k of int8, 256 of
//     int4. The m16n8k32 B fragment wants 4 consecutive k of one column per
//     register, so after a chunk lands each warp rewrites its own 16-column
//     strip into a column-major s8 strip (16 rows of KC bytes plus 16 of
//     padding): 4 x 4 byte transposes by __byte_perm, and for int4 each
//     nibble first sign-extended to a byte as unpack4 does (low nibble = even
//     k). ldmatrix.x4 on the strip then gives b0 and b1 of both n8 tiles. The
//     strip is the warp's own, so __syncwarp orders it.
//   * The staged B chunk is unpadded, its 16-byte segments XOR-swizzled by
//     the row's k quad ((row >> 2) & 7): a lane of the transpose reads the
//     4 rows of one k quad, and the 8 lanes of a quarter-warp then hit 8
//     different bank groups. A rows and strip rows are padded by 16 bytes
//     (144 or 272), so the 8 row addresses of an ldmatrix fall in 8 bank
//     groups.
//   * The ring keeps 64 KB of B in flight (6 slots), as far as the 227 KB of
//     an SM allow beside the 8 strips (5 slots for int4 at SM = 64).

#pragma once

#include "fma_f32.cuh"

namespace {

// A chunk is mma_bf16.cuh's: 16 KB of B, KC = mma_kc<int8_t, P4>() (128 k of
// int8, 256 of packed int4) in mma_b_rows<int8_t, P4>() = 128 staged rows.
// A staged A row or strip row holds KC bytes plus 16 of padding.
template <bool P4>
__host__ __device__ constexpr int s8_stride() { return mma_kc<int8_t, P4>() + 16; }
template <bool P4, int SM>
__host__ __device__ constexpr int s8_a_slot_bytes() { return SM * s8_stride<P4>(); }
template <bool P4>
__host__ __device__ constexpr int s8_b_slot_bytes() { return mma_b_rows<int8_t, P4>() * kSN; }
// the 8 warps' column-major strips: 128 columns of KC bytes, padded
template <bool P4>
__host__ __device__ constexpr int s8_strip_bytes() { return kSN * s8_stride<P4>(); }

// Ring slots: enough that kMInFlight bytes of B are in flight while the
// block multiplies the oldest chunk, as far as shared memory allows.
template <bool P4, int SM>
__host__ __device__ constexpr int s8_stages() {
  constexpr int want = 2 + kMInFlight / kMChunkBytes;
  constexpr int fit =
      (kMSmemBudget - s8_strip_bytes<P4>()) / (s8_a_slot_bytes<P4, SM>() + s8_b_slot_bytes<P4>());
  static_assert(fit >= 3, "the ring does not fit in shared memory");
  return want < fit ? want : fit;
}

// Dynamic shared memory of one block on the s8 mainloop.
template <bool P4, int SM>
__host__ __device__ constexpr int mma_s8_smem_bytes() {
  return s8_stages<P4, SM>() * (s8_a_slot_bytes<P4, SM>() + s8_b_slot_bytes<P4>()) +
         s8_strip_bytes<P4>();
}

// Byte offset of 16-byte segment s of staged B row r: segments are swizzled
// by the row's k quad.
__device__ __forceinline__ int s8_b_seg(int r, int s) {
  return r * kSN + ((s ^ ((r >> 2) & 7)) << 4);
}

// Copy one K chunk [k0, k0 + KC) of the sub-block's A rows and B columns
// into ring slot `as`/`bs`: 16-byte cp.async when aligned (zero-filling past
// M, N and kend), else byte by byte. Packed int4 B is rows [k0 / 2,
// k0 / 2 + 128) masked against ceil(kend / 2); k0 is even (kbeg is a
// multiple of bk).
template <bool P4, int SM>
__device__ __forceinline__ void s8_load_chunk(const int8_t* __restrict__ a,
                                              const int8_t* __restrict__ b, int m, int n, int k,
                                              int row0, int col0, int k0, int kend, bool aligned,
                                              int8_t* as, int8_t* bs) {
  constexpr int KC = mma_kc<int8_t, P4>();
  constexpr int A_STRIDE = s8_stride<P4>();
  constexpr int A_VECS = SM * KC / 16;
  constexpr int B_VECS = mma_b_rows<int8_t, P4>() * kSN / 16;
  const int t = threadIdx.x;
  for (int e = t; e < A_VECS; e += kThreads) {
    const int r = e / (KC / 16);
    const int kk = (e % (KC / 16)) * 16;
    const int gr = row0 + r;
    const int gk = k0 + kk;
    const int valid = gr < m ? min(max(kend - gk, 0), 16) : 0;
    const int8_t* src = a + (int64_t)gr * k + gk;
    int8_t* dst = as + r * A_STRIDE + kk;
    if (aligned) {
      cp_async16(dst, valid ? src : a, valid);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = j < valid ? src[j] : int8_t(0);
    }
  }
  const int r0 = P4 ? k0 / 2 : k0;
  const int rend = P4 ? (kend + 1) / 2 : kend;
  for (int e = t; e < B_VECS; e += kThreads) {
    const int r = e / (kSN / 16);
    const int s = e % (kSN / 16);
    const int gk = r0 + r;
    const int gc = col0 + s * 16;
    const int valid = gk < rend ? min(max(n - gc, 0), 16) : 0;
    const int8_t* src = b + (int64_t)gk * n + gc;
    int8_t* dst = bs + s8_b_seg(r, s);
    if (aligned) {
      cp_async16(dst, valid ? src : b, valid);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = j < valid ? src[j] : int8_t(0);
    }
  }
}

// Four words of four bytes each (rows r0..r3) -> their transpose: c[j]
// holds byte j of r0, r1, r2, r3, in that order.
__device__ __forceinline__ void transpose4x4(unsigned r0, unsigned r1, unsigned r2, unsigned r3,
                                             unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const unsigned t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The low nibbles of four packed int4 bytes, each sign-extended to a byte
// (unpack4's even k): a set sign bit (8) times 0x1E is 0xF0, with no carry
// out of the byte.
__device__ __forceinline__ unsigned s4_low(unsigned w) {
  const unsigned x = w & 0x0F0F0F0Fu;
  return x | ((x & 0x08080808u) * 0x1Eu);
}

// Rewrite this warp's 16 columns of one staged chunk into its column-major
// strip (16 rows of KC bytes at stride s8_stride): lane l reads the 4 staged
// rows of k quad l (one 16-byte segment each) and writes k [4l, 4l + 4) of
// every column, or for packed int4 k [8l, 8l + 8) from packed rows
// [4l, 4l + 4).
template <bool P4>
__device__ __forceinline__ void s8_transpose_strip(const int8_t* raw, int8_t* strip) {
  constexpr int STRIDE = s8_stride<P4>();
  const int lane = threadIdx.x & 31;
  const int seg = ((threadIdx.x >> 5) ^ (lane & 7)) << 4;  // s8_b_seg of rows 4l..4l+3
  uint4 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = *reinterpret_cast<const uint4*>(raw + (4 * lane + i) * kSN + seg);
  const unsigned w[4][4] = {{q[0].x, q[1].x, q[2].x, q[3].x},
                            {q[0].y, q[1].y, q[2].y, q[3].y},
                            {q[0].z, q[1].z, q[2].z, q[3].z},
                            {q[0].w, q[1].w, q[2].w, q[3].w}};
#pragma unroll
  for (int g = 0; g < 4; ++g) {  // columns 4g .. 4g + 3
    if constexpr (P4) {
      unsigned lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = s4_low(w[g][i]);
        hi[i] = s4_low(w[g][i] >> 4);
      }
      unsigned first[4], second[4];  // k 8l .. 8l + 3, 8l + 4 .. 8l + 7
      transpose4x4(lo[0], hi[0], lo[1], hi[1], first);
      transpose4x4(lo[2], hi[2], lo[3], hi[3], second);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint2*>(strip + (4 * g + j) * STRIDE + 8 * lane) =
            make_uint2(first[j], second[j]);
    } else {
      unsigned c[4];
      transpose4x4(w[g][0], w[g][1], w[g][2], w[g][3], c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<unsigned*>(strip + (4 * g + j) * STRIDE + 4 * lane) = c[j];
    }
  }
}

// d += a (16 x 32, row) @ b (32 x 8, col), s8 in, s32 accumulate (exact).
__device__ __forceinline__ void mma_16832_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = the sums over [kbeg, kend) of the SM x 128 sub-block at (row0, col0)
// of A (int8) @ B (int8, or packed int4 when P4), in the C-fragment layout;
// each bk step's int32 sum enters acc at the step's end. S - 1 chunks are in
// flight while the block multiplies the oldest.
template <bool P4, int SM>
__device__ __forceinline__ void mma_s8_subblock(const int8_t* __restrict__ a,
                                                const int8_t* __restrict__ b, int m, int n, int k,
                                                int row0, int col0, int kbeg, int kend, int bk,
                                                bool aligned, float (&acc)[mma_mt<SM>()][2][4],
                                                unsigned char* smem) {
  constexpr int MT = mma_mt<SM>();
  constexpr int KC = mma_kc<int8_t, P4>();
  constexpr int STRIDE = s8_stride<P4>();
  constexpr int S = s8_stages<P4, SM>();
  constexpr int A_SLOT = s8_a_slot_bytes<P4, SM>();
  constexpr int B_SLOT = s8_b_slot_bytes<P4>();
  int s[MT][2][4];  // the current bk step's int32 sums
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        s[i][j][e] = 0;
      }
  if (row0 >= m || col0 >= n) return;  // uniform across the block

  int8_t* ring_a = reinterpret_cast<int8_t*>(smem);
  int8_t* ring_b = ring_a + S * A_SLOT;
  int8_t* strip = ring_b + S * B_SLOT + (threadIdx.x >> 5) * 16 * STRIDE;
  const int lane = threadIdx.x & 31;
  // this lane's ldmatrix row address (bytes): A's m16 x k32 tile as 4 (x2
  // at SM = 8: 2) 8 x 16-byte matrices, as the bf16 path's m16 x k16; the
  // strip's 16 columns x k32 as b0, b1 of n8 tile 0, then of tile 1
  const int a_off = SM < 16 ? (lane & 7) * STRIDE + ((lane >> 3) & 1) * 16
                            : (lane & 15) * STRIDE + (lane >> 4) * 16;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * STRIDE + ((lane >> 3) & 1) * 16;
  const int nchunks = (kend - kbeg + KC - 1) / KC;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nchunks)
      s8_load_chunk<P4, SM>(a, b, m, n, k, row0, col0, kbeg + st * KC, kend, aligned,
                            ring_a + st * A_SLOT, ring_b + st * B_SLOT);
    cp_async_commit();
  }
  int step_end = min(kbeg + bk, kend);  // where the current bk step's sums enter acc
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and slot c-1 is free again
    const int next = c + S - 1;
    if (next < nchunks) {
      const int slot = next % S;
      s8_load_chunk<P4, SM>(a, b, m, n, k, row0, col0, kbeg + next * KC, kend, aligned,
                            ring_a + slot * A_SLOT, ring_b + slot * B_SLOT);
    }
    cp_async_commit();
    const int slot = c % S;
    const int8_t* a_s = ring_a + slot * A_SLOT;
    __syncwarp();  // the warp's reads of the previous strip are done
    s8_transpose_strip<P4>(ring_b + slot * B_SLOT, strip);
    __syncwarp();
    const int k0 = kbeg + c * KC;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      const int kpos = k0 + ks * 32;
      if (kpos >= kend) break;  // uniform: the rest of the chunk is past kend
      unsigned bf[4];
      ldmatrix_x4(bf, strip + b_off + ks * 32);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned af[4];
        if constexpr (SM < 16) {
          unsigned lo[2];
          ldmatrix_x2(lo, a_s + a_off + ks * 32);
          af[0] = lo[0];
          af[1] = 0u;  // rows 8-15 of the m16 tile: zeros
          af[2] = lo[1];
          af[3] = 0u;
        } else {
          ldmatrix_x4(af, a_s + a_off + i * 16 * STRIDE + ks * 32);
        }
        mma_16832_s8(s[i][0], af, bf[0], bf[1]);
        mma_16832_s8(s[i][1], af, bf[2], bf[3]);
      }
      if (kpos + 32 >= step_end) {  // a bk step ends: its exact sums enter acc
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][j][e] += (float)s[i][j][e];
              s[i][j][e] = 0;
            }
        step_end = min(step_end + bk, kend);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the next sub-block refills the ring
}

// Dynamic shared memory of one block of B1, B2, B5 or B6: the bf16
// tensor-core ring for bf16 activations, the s8 one for int8 activations,
// the f32 FMA ring for f32.
template <typename TA, typename TB, bool P4, int SM>
constexpr int mainloop_smem_bytes() {
  if constexpr (uses_mma<TA>())
    return mma_smem_bytes<TB, P4, SM>();
  else if constexpr (std::is_same<TA, int8_t>::value)
    return mma_s8_smem_bytes<P4, SM>();
  else
    return fma_smem_bytes<TB, P4, SM>();
}

}  // namespace
