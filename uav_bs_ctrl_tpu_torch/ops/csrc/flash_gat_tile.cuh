// What the projection-fused GATv2 kernels flash_gat_fused.cu (#2) and flash_gat_fused_bwd.cu
// (#3) share: slot tiles whose projection runs on the tensor cores, for rows of more than
// two tiles' worth of slots and heads of 32 or 64 columns, 8 heads at most (use_tiles);
// other calls take the warp-per-(row, head) body of flash_gat_common.cuh.
//
// A CTA has one warp per head (H warps) and walks rows n = blockIdx.x, + gridDim.x, ...; the
// grid is what the card holds at once (grid_for), so a CTA takes many rows and loads its
// head's weights once. Warp h works on head h's F columns in m16 tiles: the projection
// el^T = W_h^T x^T is an mma.sync product with the head's columns as M (16 a tile), the
// features as K (D <= 8, zero-padded to 4 or 8) and a tile of 8 of the row's valid slots as
// N. Lane l (g = l / 4, t = l % 4) so holds columns g and g + 8 of each m16 tile for slots
// 2t and 2t + 1 of the tile (the accumulator layout, mma_sm90.cuh): a score, a slot's sum
// over the head's columns, is the lane's own sum of its columns and then a reduce-scatter
// over the 8 lanes g that share t (3 shuffles for two slots), where the warp-per-(row,
// head) design took a 5-step butterfly per slot, and the projection is 1 (bf16) or 4 (f32)
// HMMA per 16 x 8 block where it took D FMAs per column on the CUDA cores.
//
// Tiles hold the slots of one row only: a row's valid slots, listed by the warp from its
// staged mask, padded to a whole tile. er, the softmax and der so stay per warp and per row,
// with no segmented sums, and the warps of a CTA never wait for each other (but for dx).
// The next unit of rows' data travels by cp.async into a per-warp ring while a unit is
// computed, and W and b of the head are staged once in shared memory.
//
// The products are tf32 mma.sync (m16n8k4 for D <= 4, m16n8k8 else). An f32 value is split
// into big = tf32(v) and small = tf32(v - big) (tarmac_step_common.cuh's 3xTF32, here with
// small x small too, see project). A bf16 value is a tf32 value (8 mantissa bits of 10), so
// at bf16 the small parts are 0 and the projection is one exact pass: the bf16 instantiation
// does the f32 one's arithmetic on the widened operands, bit for bit. One m16n8k4 tf32
// instruction does the tensor work of one m16n8k8 bf16 (half the depth at half the rate), so
// a bf16 product would not be cheaper at D <= 4 and would not be exact.
//
// What bounds the kernels is the instructions each lane issues per column and slot beside the
// products (#2: the LeakyReLU select and the attn FMA; #3 about 10) and per row (the ring's
// copies, the list, the outputs): on an NVIDIA H100 80GB HBM3 at 700 W they reach 11-12 % of
// their f32 bound at bench.py's hoisted shape (chip_ab.py, PERF.md).

#pragma once

#include <cstdint>
#include <type_traits>

#include "flash_gat_common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kSlots = 8;                 // slots a tile: the products' N
constexpr unsigned kOneBits = 0x3f800000u;   // 1.0f: a tf32 operand as it is
constexpr int kTileBudget = 96 * 1024;    // bytes of the warps' areas together, at most
constexpr int kTileThreads = 256;         // a tile CTA's threads at most: 8 heads

// bf16 operands are tf32 values: their products are exact in one pass.
template <class T>
constexpr bool kExact = !std::is_same<T, float>::value;

// v as tf32 parts: big = tf32(v), small = tf32(v - big), or the bits of v and 0 where T's
// values are tf32 values already.
template <class T>
__device__ __forceinline__ void split_operand(float v, unsigned& big, unsigned& small) {
  if constexpr (kExact<T>) {
    big = float_bits(v);
    small = 0u;
  } else {
    big = to_tf32(v);
    small = to_tf32(v - bits_float(big));
  }
}

// d += a b for one m16 tile, depth KD (4 or 8): a the A fragment of the tile (KD / 2
// registers), b the B fragment (KD / 4).
template <int KD>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[KD / 2],
                                         const unsigned (&b)[KD / 4]) {
  if constexpr (KD == 4) {
    mma_tf32_1684(d, a, b);
  } else {
    mma_tf32_1688(d, a, b);
  }
}

// d += x^T w for one m16 tile from their tf32 parts: big x big into d as the caller set it
// (zero, or a value the tensor cores add exactly before they cut), then the small parts'
// three products (small x small, small x big, big x small) into a zeroed fragment, added by
// an FADD. Each product of 4 is exact, and the tensor cores cut each sum toward zero as they
// align it, so big x big alone carries a cut of at most one ulp of its largest term: z = el
// + er keeps the sign an f32 FMA chain gives it within about an ulp of 0, where the
// LeakyReLU's slope changes. One exact pass where T's operands are tf32 values.
template <class T, int KD>
__device__ __forceinline__ void project(float (&d)[4], const unsigned (&wa)[KD / 2],
                                        const unsigned (&ws)[KD / 2],
                                        const unsigned (&xb)[KD / 4],
                                        const unsigned (&xs)[KD / 4]) {
  mma_tf32<KD>(d, wa, xb);
  if constexpr (!kExact<T>) {
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32<KD>(e, ws, xs);
    mma_tf32<KD>(e, ws, xb);
    mma_tf32<KD>(e, wa, xs);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += e[i];
  }
}

// ---- The staging ring ----
// A warp walks its CTA's rows n = blockIdx.x, + gridDim.x, ... as units of at most `chunk`
// slots (one unit a row where M <= chunk). While it computes a unit, the next unit's mask
// and x spans and the row's per-column operands (the head's slice of er, and of g and out in
// the backward, with the row's statistics) travel from device memory into the other buffer
// of its two-buffer ring by cp.async, in 4-byte words: a span that starts inside a word (a
// bf16 row) brings the word's first half along and is read from a 2-byte offset, and its
// last word reads only its own bytes. At compute time the warp lists the unit's valid slots
// from the staged mask and reads their features through the list.

struct Unit {
  int n, j0;                               // row n, slots [j0, j0 + chunk)
};

// Words that hold `count` elements of `esize` bytes from any offset in their first word,
// rounded up to 16 bytes so that every span of the ring starts 16-byte aligned.
__host__ __device__ constexpr int span_words(int count, int esize) {
  return ((count * esize + 3) / 4 + 1 + 3) / 4 * 4;
}

// Word offsets within a warp's area: each ring buffer's mask, x, per-column row slices (nrow
// of F) and statistics; the list of a unit's valid slots; the head's W rows and b in f32
// (wf, [D + 1][F]).
struct RingLayout {
  int mask, x, row, stat, buf, list, wf, total;
};

__host__ __device__ inline RingLayout ring_layout(int chunk, int D, int F, int esize, int nrow,
                                                  int stats) {
  RingLayout r;
  r.mask = 0;
  r.x = span_words(chunk, esize);
  r.row = r.x + span_words(chunk * D, esize);
  r.stat = r.row + nrow * span_words(F, esize);
  r.buf = (r.stat + stats + 3) / 4 * 4;
  r.list = 2 * r.buf;
  r.wf = r.list + chunk;
  r.total = (r.wf + (D + 1) * F + 3) / 4 * 4;
  return r;
}

// Elements src[0, count) into the words at dst by cp.async (none of them waited for): 16
// bytes a copy where src and dst are 16-byte aligned, else 4.
template <class T>
__device__ __forceinline__ void fetch_span(unsigned* dst, const T* src, int count, int lane) {
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b1 = b0 + (uintptr_t)count * sizeof(T), w0 = b0 & ~uintptr_t(3);
  const int words = (int)((b1 - w0 + 3) / 4);
  int i = lane;
  if (((b0 | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int chunks = (int)((b1 - b0) / 16);
    for (; i < chunks; i += 32)
      cp_async_16(dst + 4 * i, reinterpret_cast<const void*>(b0 + 16 * (uintptr_t)i));
    i = 4 * chunks + lane;
  }
  for (; i < words; i += 32) {
    const uintptr_t a = w0 + 4 * (uintptr_t)i;
    cp_async_4(dst + i, reinterpret_cast<const void*>(a), b1 - a < 4 ? (int)(b1 - a) : 4);
  }
}

// Where fetch_span put src[0].
template <class T>
__device__ __forceinline__ const T* span_at(const unsigned* dst, const T* src) {
  return reinterpret_cast<const T*>(reinterpret_cast<const char*>(dst) +
                                    (reinterpret_cast<uintptr_t>(src) & 3));
}

// The chunk positions of the valid slots of a staged mask span of `len` (mask > 0), in
// order, into list, padded with -1 to a whole tile; returns their count (the same in every
// lane). The caller __syncwarp()s before the list is read.
template <class T>
__device__ __forceinline__ int list_staged(const T* m_s, int len, int* list, int lane) {
  int cnt = 0;
  for (int w0 = 0; w0 < len; w0 += 32) {           // uniform over the warp
    const int j = w0 + lane;
    const bool valid = j < len && to_f32(m_s[j]) > 0.f;
    const unsigned bits = __ballot_sync(kFull, valid);
    if (valid) list[cnt + __popc(bits & ((1u << lane) - 1u))] = j;
    cnt += __popc(bits);
  }
  const int pad = (cnt + kSlots - 1) / kSlots * kSlots;
  if (cnt + lane < pad) list[cnt + lane] = -1;
  return cnt;
}

// Feature d of listed slot k of a staged x span (0 on a padding slot and beyond D).
template <class T>
__device__ __forceinline__ float x_at(const T* x_s, const int* list, int k, int d, int D) {
  const int p = list[k];
  return p >= 0 && d < D ? to_f32(x_s[p * D + d]) : 0.f;
}

// Lane (g, t)'s B fragment of the projection over the tile of slots from k0: feature t (and
// t + 4) of listed slot k0 + g, as tf32 parts.
template <class T, int KD>
__device__ __forceinline__ void x_fragment(const T* x_s, const int* list, int k0, int D, int g,
                                           int t, unsigned (&xb)[KD / 4],
                                           unsigned (&xsm)[KD / 4]) {
  const int p = list[k0 + g];
#pragma unroll
  for (int i = 0; i < KD / 4; ++i) {
    const int d = t + 4 * i;
    split_operand<T>(p >= 0 && d < D ? to_f32(x_s[p * D + d]) : 0.f, xb[i], xsm[i]);
  }
}

// The head's W rows and b (columns c0 .. c0 + F) in f32 into wf [D + 1][F], once a kernel.
template <class T>
__device__ __forceinline__ void stage_head(float* wf, const T* __restrict__ w,
                                           const T* __restrict__ b, int c0, int F, int D,
                                           int HF, int lane) {
  for (int i = lane; i < (D + 1) * F; i += 32) {
    const int d = i / F, f = i % F;
    wf[i] = to_f32(d < D ? w[(size_t)d * HF + c0 + f] : b[c0 + f]);
  }
  __syncwarp();
}

// A warp's MT m16 tiles of the columns c0 + 16 m + {g, g + 8}: W^T's A fragments (tf32
// parts; feature t, and t + 4 at KD = 8, of columns g and g + 8), attn and slope * attn.
template <class T, int MT, int KD>
struct Cols {
  unsigned wa[MT][KD / 2], ws[MT][KD / 2];
  float at[MT][2], sat[MT][2];

  __device__ __forceinline__ void load(const T* __restrict__ w, const T* __restrict__ attn,
                                       int c0, int D, int HF, float slope, int g, int t) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int r = 0; r < KD / 2; ++r) {       // a[r]: column g (+8 for r odd), feature t (+4)
        const int col = c0 + 16 * m + g + 8 * (r & 1), d = t + 4 * (r >> 1);
        split_operand<T>(d < D ? to_f32(w[(size_t)d * HF + col]) : 0.f, wa[m][r], ws[m][r]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        at[m][i] = to_f32(attn[c0 + 16 * m + g + 8 * i]);    // attn [H, F] as a row of HF
        sat[m][i] = slope * at[m][i];
      }
    }
  }
};

// v at the lane's columns c0 + 16 m + {g, g + 8} of a row (staged or not).
template <int MT, class T>
__device__ __forceinline__ void row_cols(const T* row, int c0, int g, float (&v)[MT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) v[m][i] = to_f32(row[c0 + 16 * m + g + 8 * i]);
}

// The sum over the 8 lanes g that share t.
__device__ __forceinline__ float sum_over_g(float v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Two sums over the 8 lanes g that share t, at half the shuffles: a lane keeps the first
// where hi is 0 and the second where it is 1 (hi the lane's bit 16, g >= 4), swapping the
// other half with lane ^ 16, then sums over the 4 lanes g of its half.
__device__ __forceinline__ float sum_pair_over_g(float first, float second, int hi) {
  float v = (hi ? second : first) + __shfl_xor_sync(kFull, hi ? first : second, 16);
  v += __shfl_xor_sync(kFull, v, 8);
  return v + __shfl_xor_sync(kFull, v, 4);
}

// The sum over the 4 lanes t that share g.
__device__ __forceinline__ float sum_over_t(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Slots a unit: a whole number of mask words, at most kMaxChunk, and few enough that the H
// warps' areas (ring_layout) fit kTileBudget; at least 32.
inline int tile_chunk(int M, int H, int D, int F, int esize, int nrow, int stats) {
  const int words = (M + 31) / 32;
  int chunk = words == 0 ? 32 : (words * 32 < kMaxChunk ? words * 32 : kMaxChunk);
  while (chunk > 32 && 4 * H * ring_layout(chunk, D, F, esize, nrow, stats).total > kTileBudget)
    chunk -= 32;
  return chunk;
}

// Whether a call takes the slot tiles: rows of more than two tiles' worth of slots and
// heads of 32 or 64 columns (held in registers), at most 8 (kTileThreads). Shorter rows
// ('near', M = 7; the host loop's exp1 M = 10) take the warp-per-(row, head) body of
// flash_gat_common.cuh, which was faster there on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md: a tile's fixed cost a row, its staging, list and outputs, outweighs its
// projection when a row fills one tile); so do wider heads and more heads, which no run
// has.
inline bool use_tiles(int M, int F, int H) { return M > 2 * kSlots && F <= 64 && H <= 8; }

// The CTAs of a launch over `rows` rows: as many as the card holds at once (its SMs times
// the kernel's CTAs an SM at this size), at most `rows` and `cap`. `cache` keeps the card's
// figure for the last (threads, smem) of the caller's kernel.
struct GridCache {
  int threads = -1;
  size_t smem = 0;
  int full = 0;
};

inline cudaError_t grid_for(const void* kernel, int threads, size_t smem, int rows, int cap,
                            GridCache& cache, int& grid) {
  if (cache.threads != threads || cache.smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    cache = GridCache{threads, smem, sms * (per_sm > 0 ? per_sm : 1)};
  }
  grid = cache.full < cap ? cache.full : cap;
  if (grid > rows) grid = rows;
  return cudaSuccess;
}

}  // namespace
