// Paged split-KV flash decoding for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/attention.py::_flash_decode (kernel body
// _decode_kernel), the Pallas TPU kernel every serving decode step calls
// once per layer.  Same function: single-token attention for each slot
// over its first lengths[slot] keys, grouped-query heads sharing their kv
// head, lengths == 0 giving exactly zero.  Unlike the TPU path, which is
// handed a gathered [slots, h_kv, max_len, d] copy of each slot's pages,
// this kernel reads K/V in place through the page table: the gather is
// folded into the address computation, so no cache view is materialised
// (on this card that copy alone would move the whole per-slot view twice
// per layer per step).  The same kernel also serves a contiguous
// [b, h_kv, s, d] cache (no page table: one "page" per slot).
//
// What bounds it on the H100: HBM bytes.  Each step reads every live key
// and value once (2 * sum(lengths) * h_kv * d * 2 bytes in bf16, ~67 MB
// at 8 slots x 2048 keys) and does ~2 FLOP per byte, two orders below the
// card's balance point, so the floor is bytes / 3.35 TB/s and the design
// goes after bytes in flight per SM:
//   * one CTA per (KV split, slot, kv head), 4 warps, two CTAs an SM (99 KB
//     of shared memory each in bf16 at d = 128); the rep query heads of
//     the group share every K/V tile (the TPU kernel's (rep, d) tile);
//   * each warp streams its own share of the split's keys (16-key tiles,
//     warp w taking tiles w, w + 4, ...) through its own 3-stage ring:
//     16-byte cp.async copies of the raw bf16 (or f32) rows, each row's
//     address looked up once through the page table and zero-filled past
//     the length, so two tiles are in flight while the third is reduced.  No
//     block barrier sits in the loop: a warp waits only on its own copies;
//   * K/V stay in their storage type in shared memory (XOR-swizzled
//     16-byte chunks: conflict-free for both the key-per-lane score pass
//     and the column-per-lane P V pass) and are widened to f32 in
//     registers at use; every product and sum is f32 on the CUDA cores (a
//     tensor core buys nothing at ~2 FLOP per byte, and an m16 tile over
//     rep = 4 rows would waste three quarters of it);
//   * the split grid is sized from the slot's capacity (no device-to-host
//     read of the lengths), with the split index slowest so the live low
//     splits are dispatched first; a CTA whose split starts at or past
//     its slot's length exits before loading anything, and the merge
//     reads only the live splits' partials, so the splits past a length
//     cost a CTA slot and nothing else;
//   * each split keeps a running max / normalizer / accumulator per warp
//     in registers, merges its 4 warps by log-sum-exp in shared memory
//     and writes one partial; blocks carry nothing between them, so a
//     second small kernel merges the splits (the step the TPU kernel did
//     on its sequential grid axis).  No atomics: launches repeat bit for
//     bit.
// Keys at or past the length are never read (zero-filled) and take
// probability 0, so recycled-page garbage never contributes.  Both
// launches allocate nothing: the partials are scratch the caller passes
// in.
//
// fp8 cold pages (hvd_flash_decode_fp8; replaces the same TPU kernel fed
// by horovod_tpu/serving/decode.py's gather blend, :397-404).  A page
// whose cmask[slot, i] is set lives in the e4m3 pool at ctable[slot, i],
// one f32 scale per (page, offset) row; its page_table entry is the
// scratch page and is never read.  A compressed row moves half the bytes
// of a bf16 row and keeps every copy in flight, as a plain row does:
//   * the loader (load_tile_fp8) copies a compressed row's D raw e4m3
//     bytes with 16-byte cp.async into the first D / 16 chunks of the
//     row's tile slot (the T row's XOR swizzle, so both passes below read
//     without bank conflicts), and its K and V scales with 4-byte
//     cp.async into a [2][TK] f32 array beside each stage; it converts
//     nothing and never waits on its own copies.  Its page-table, ctable
//     and cmask lookups are loaded a tile ahead;
//   * a tile's rows are a 16-bit mask kept in registers (a ballot at
//     load): all e4m3 (every live row compressed; rows past the length
//     then read as zero bytes with scale 0), all T, or mixed.  At page 16
//     a tile is one page, so the choice is warp-uniform; at a page size
//     that splits a tile (4, 8, 24, ...) a mixed tile's e4m3 rows are
//     widened in place into T rows (widen_rows) and it reads as all T;
//   * the score and P V passes widen an e4m3 row at use: f32(e4m3) *
//     scale (__fmul_rn), rounded to T (the reference's .astype(view.dtype))
//     and widened back to f32, then the same products and sums in the same
//     order as for a T row.  So a step over compressed pages is bitwise the
//     uncompressed kernel over a pool holding the dequantised rows.
// What bounds it is not the bytes.  A tile of e4m3 rows moves half a bf16
// tile's bytes but costs its warp about 3.5 more instructions a value (the
// e4m3x2 -> f16x2 conversion, f16 -> f32, the scale product, the rounding
// to bf16) on top of the FMAs, and such a warp's loop runs as long with
// every copy an L2 hit as from HBM (profile_torch_decode.py): at two CTAs
// (eight warps) an SM it waits on its own instructions.  A split's CTA
// ends with its slowest warp; with every other page compressed, warps 0
// and 2 take every e4m3 tile, so their widening is the critical path.
// Code a tile does not run still slows it, so mixed tiles have no compute
// path of their own and the e4m3 score loop is unrolled by two.  The e4m3
// row fits in half (bf16) or a quarter (f32) of its slot; the scales add
// 1.5 KB a CTA, and every FP8 instantiation keeps as many CTAs an SM as
// its FP8 = false twin.  The uncompressed instantiations compile the same
// instructions as before: every fp8 branch is `if constexpr`, and their
// score and P V loops stay inline in the kernel (compiled through
// tile_dot and tile_pv, they allocate registers differently).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NW = 4;          // warps per CTA
constexpr int NT = 32 * NW;
constexpr int TK = 16;         // keys per warp tile
constexpr int STAGES = 3;      // ring depth per warp
constexpr uint32_t ALL_ROWS = (1u << TK) - 1;   // a tile's rows as bits

// The e4m3 pool of one layer of a compress=True cache (unused when FP8 is
// false).  kq/vq have the pool's element layout; the scales are
// [pages, page_size]; ctable and cmask are [slots, pps].
struct Fp8Pages {
  const uint8_t* kq;
  const uint8_t* vq;
  const float* kscale;
  const float* vscale;
  const int* ctable;
  const uint8_t* cmask;
};

template <typename T, int D>
__host__ __device__ constexpr int row_bytes() { return D * (int)sizeof(T); }

// The rings, q, P, and with FP8 each stage's [2][TK] K and V scales.
template <typename T, int D, int REP, bool FP8>
constexpr size_t smem_bytes() {
  return (size_t)NW * STAGES * 2 * TK * row_bytes<T, D>() +
         sizeof(float) * (REP * D + NW * TK * REP) +
         (FP8 ? sizeof(float) * NW * STAGES * 2 * TK : 0);
}

// Byte offset of 16-byte chunk `chunk` of key row `row` in a tile:
// chunks XOR-swizzled by the row's low three bits.
template <typename T, int D>
__device__ __forceinline__ int chunk_at(int row, int chunk) {
  return row * row_bytes<T, D>() + ((chunk ^ (row & 7)) << 4);
}

// The 16 bytes of a chunk as f32.
__device__ __forceinline__ void widen(const uint4& raw, float* f,
                                      const float*) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void widen2(uint32_t w, float* f) {
  const float2 x = hvd::mma::unpack_bf16(w);
  f[0] = x.x;
  f[1] = x.y;
}

__device__ __forceinline__ void widen(const uint4& raw, float* f,
                                      const __nv_bfloat16*) {
  widen2(raw.x, f);
  widen2(raw.y, f + 2);
  widen2(raw.z, f + 4);
  widen2(raw.w, f + 6);
}

// Two e4m3 codes (low byte first) as f32: exact, via half.
__device__ __forceinline__ float2 e4m3x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// Two e4m3 codes times `s`, each product rounded to T and widened back:
// the values a T pool holding the dequantised row gives.
__device__ __forceinline__ void dequant2(uint32_t pair, float s, float* f,
                                         const float*) {
  const float2 x = e4m3x2(pair);
  f[0] = __fmul_rn(x.x, s);
  f[1] = __fmul_rn(x.y, s);
}

// bf16: each product is rounded into the high half of a word whose low
// half is zero, which is that bf16 value as f32: one conversion a value
// and no unpacking.
__device__ __forceinline__ void dequant2(uint32_t pair, float s, float* f,
                                         const __nv_bfloat16*) {
  const float2 x = e4m3x2(pair);
  f[0] = __uint_as_float(hvd::mma::pack_bf16(0.f, __fmul_rn(x.x, s)));
  f[1] = __uint_as_float(hvd::mma::pack_bf16(0.f, __fmul_rn(x.y, s)));
}

// The four codes of a word (low byte first), dequantised.
template <typename T>
__device__ __forceinline__ void dequant4(uint32_t w, float s, float* f) {
  dequant2(w & 0xffffu, s, f, static_cast<const T*>(nullptr));
  dequant2(w >> 16, s, f + 2, static_cast<const T*>(nullptr));
}

// N (2 or 4) consecutive elements at a shared address, as f32.
template <typename T, int N>
__device__ __forceinline__ void load_elems(const unsigned char* p, float* f) {
  static_assert(N == 2 || N == 4, "2 or 4 columns a lane");
  if constexpr (sizeof(T) == 4) {
    if constexpr (N == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p);
      f[0] = x.x; f[1] = x.y;
    }
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    widen2(x.x, f);
    widen2(x.y, f + 2);
  } else {
    widen2(*reinterpret_cast<const uint32_t*>(p), f);
  }
}

// The same N columns of an e4m3 row with scale `s`, dequantised.
template <typename T, int N>
__device__ __forceinline__ void load_e4m3(const unsigned char* p, float s,
                                          float* f) {
  static_assert(N == 2 || N == 4, "2 or 4 columns a lane");
  if constexpr (N == 4)
    dequant4<T>(*reinterpret_cast<const uint32_t*>(p), s, f);
  else
    dequant2(*reinterpret_cast<const uint16_t*>(p), s, f,
             static_cast<const T*>(nullptr));
}

// Copies a warp's K and V tile of T rows into the ring stage at shared
// address `dst` (K, then V TILE bytes later): 16-byte cp.async copies,
// zero-filled at and past `end`; `mine` is the element offset of key
// k0 + lane % TK's row, which the lanes that copy a row take by shuffle.
template <typename T, int D>
__device__ __forceinline__ void copy_rows(const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          unsigned long long mine, int k0,
                                          int end, uint32_t dst, int lane) {
  constexpr int CH = row_bytes<T, D>() / 16;
  constexpr uint32_t TILE = TK * row_bytes<T, D>();
#pragma unroll
  for (int it = 0; it < TK * CH / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / CH, c = idx % CH;
    const size_t off = __shfl_sync(0xffffffffu, mine, r);
    const bool ok = k0 + r < end;
    const uint32_t at = dst + chunk_at<T, D>(r, c);
    hvd::mma::cp_async16(
        at, reinterpret_cast<const unsigned char*>(k + off) + 16 * c, ok);
    hvd::mma::cp_async16(
        at + TILE, reinterpret_cast<const unsigned char*>(v + off) + 16 * c,
        ok);
  }
}

// One warp's K and V tile of keys [k0, k0 + TK): lane l looks up the page
// of key l % 16 once (one page per slot when there is no table).
template <typename T, int D>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ slot_pages, int slot, int page_size,
    int64_t stride_page, int64_t stride_off, size_t head_off, int k0,
    int end, uint32_t dst, int lane) {
  const int pos = k0 + (lane & (TK - 1));
  unsigned long long mine = 0;
  if (pos < end) {
    const int page = slot_pages ? slot_pages[pos / page_size] : slot;
    mine = (size_t)page * stride_page +
           (size_t)(pos % page_size) * stride_off + head_off;
  }
  copy_rows<T, D>(k, v, mine, k0, end, dst, lane);
}

// One lane's lookups for key k0 + lane % TK of a tile (FP8): its page in
// the T pool, its page in the e4m3 pool and whether that one holds it.
// Loaded a tile before the tile's copies are issued, so the loads land
// while the warp reduces.
struct RowPages {
  int page, cpage, comp;
};

__device__ __forceinline__ RowPages look_up(
    const int* __restrict__ slot_pages, const int* __restrict__ slot_cpages,
    const uint8_t* __restrict__ slot_cmask, int page_size, int k0, int end,
    int lane) {
  RowPages p{0, 0, 0};
  const int pos = k0 + (lane & (TK - 1));
  if (pos < end) {
    const int pi = pos / page_size;
    p.page = slot_pages[pi];
    p.cpage = slot_cpages[pi];
    p.comp = slot_cmask[pi];
  }
  return p;
}

// load_tile for a pool with e4m3 pages: a compressed row's D e4m3 bytes go
// to chunks 0 .. D/16 - 1 of its slot (the T row's swizzle) and its K and
// V scales to the stage's [2][TK] f32 array at shared address `sc` (lane l
// copies row l % TK's K scale below TK, its V scale above), all with
// cp.async.  Returns the tile's e4m3 rows as bits: ALL_ROWS when every
// live row is compressed (the rows past `end` are then zero bytes with
// scale 0, which widen to the +0 a zero-filled T row holds), else the
// live compressed rows.
template <typename T, int D>
__device__ __forceinline__ uint32_t load_tile_fp8(
    const T* __restrict__ k, const T* __restrict__ v, const Fp8Pages& f8,
    const RowPages& rp, int page_size, int64_t stride_page,
    int64_t stride_off, size_t head_off, int k0, int end, uint32_t dst,
    uint32_t sc, int lane) {
  using namespace hvd::mma;
  constexpr int CH = row_bytes<T, D>() / 16;
  constexpr int FCH = D / 16;              // 16-byte chunks of an e4m3 row
  constexpr uint32_t TILE = TK * row_bytes<T, D>();
  const int pos = k0 + (lane & (TK - 1));
  const bool live = pos < end;
  const bool comp = live && rp.comp;
  const int at_page = pos % page_size;
  const unsigned long long mine =
      live ? (size_t)(comp ? rp.cpage : rp.page) * stride_page +
                 (size_t)at_page * stride_off + head_off
           : 0;
  const uint32_t cm = __ballot_sync(0xffffffffu, comp) & ALL_ROWS;
  const uint32_t lm = __ballot_sync(0xffffffffu, live) & ALL_ROWS;
  const uint32_t rows = (cm | (~lm & ALL_ROWS)) == ALL_ROWS ? ALL_ROWS : cm;
  if (rows)
    cp_async4(sc + 4 * lane,
              (lane < TK ? f8.kscale : f8.vscale) +
                  (comp ? (size_t)rp.cpage * page_size + at_page : 0),
              comp);
  if (rows == 0) {
    copy_rows<T, D>(k, v, mine, k0, end, dst, lane);
  } else if (rows == ALL_ROWS) {
#pragma unroll
    for (int it = 0; it < TK * FCH / 32; ++it) {
      const int idx = it * 32 + lane;
      const int r = idx / FCH, c = idx % FCH;
      const size_t off = __shfl_sync(0xffffffffu, mine, r);
      const bool ok = k0 + r < end;
      const uint32_t at = dst + chunk_at<T, D>(r, c);
      cp_async16(at, f8.kq + off + 16 * c, ok);
      cp_async16(at + TILE, f8.vq + off + 16 * c, ok);
    }
  } else {   // mixed: each row as its page is stored (a rolled loop)
#pragma unroll 1
    for (int it = 0; it < TK * CH / 32; ++it) {
      const int idx = it * 32 + lane;
      const int r = idx / CH, c = idx % CH;
      const size_t off = __shfl_sync(0xffffffffu, mine, r);
      const bool ok = k0 + r < end;
      const uint32_t at = dst + chunk_at<T, D>(r, c);
      if ((rows >> r) & 1) {   // live and compressed
        if (c < FCH) {
          cp_async16(at, f8.kq + off + 16 * c, true);
          cp_async16(at + TILE, f8.vq + off + 16 * c, true);
        }
      } else {
        cp_async16(at, reinterpret_cast<const unsigned char*>(k + off) +
                           16 * c, ok);
        cp_async16(at + TILE,
                   reinterpret_cast<const unsigned char*>(v + off) + 16 * c,
                   ok);
      }
    }
  }
  return rows;
}

// A 16-byte chunk of EPC values (exactly representable in T) stored as T.
__device__ __forceinline__ void store_chunk(unsigned char* p, const float* f,
                                            const float*) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_chunk(unsigned char* p, const float* f,
                                            const __nv_bfloat16*) {
  // Each f holds a bf16 value in its high half: keep the high halves.
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = __byte_perm(__float_as_uint(f[2 * i]),
                       __float_as_uint(f[2 * i + 1]), 0x7632);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A mixed tile's e4m3 rows (the bits of `rows`) widened in place into T
// rows, after which the tile reads as all T.  Lane l owns row l % TK of
// the K tile (l < TK) or of the V tile and goes chunk by chunk from the
// last, so the T chunks it writes for e4m3 chunk c (logical indices
// c * 16 / EPC and up) never overwrite an e4m3 chunk it has still to
// read.  A rolled loop, and mixed tiles have no compute path of their
// own: pages that split a tile are not the served case, and code the
// common tiles never run still slows their loop.
template <typename T, int D>
__device__ __forceinline__ void widen_rows(unsigned char* kt, const float* sc,
                                           uint32_t rows, int lane) {
  constexpr int EPC = 16 / sizeof(T);
  const int r = lane % TK;
  if ((rows >> r) & 1) {
    unsigned char* tile = kt + (lane / TK) * TK * row_bytes<T, D>();
    const float s = sc[lane];   // K scales below TK, V scales above
#pragma unroll 1
    for (int c = D / 16 - 1; c >= 0; --c) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(tile + chunk_at<T, D>(r, c));
      float f[16];
      dequant4<T>(raw.x, s, f);
      dequant4<T>(raw.y, s, f + 4);
      dequant4<T>(raw.z, s, f + 8);
      dequant4<T>(raw.w, s, f + 12);
#pragma unroll
      for (int t = 0; t < 16 / EPC; ++t)
        store_chunk(tile + chunk_at<T, D>(r, c * (16 / EPC) + t),
                    f + t * EPC, static_cast<const T*>(nullptr));
    }
  }
  __syncwarp();   // every row widened before any lane reads the tile
}

// The FP8 instantiations' score pass: dot[r] = q_r . k over this lane's
// part of its key's row (lane = key lane % TK, part lane / TK).  In an
// e4m3 tile each row is read 16 codes a chunk and widened to the
// dequantised T row's values; a T tile runs a copy of the uncompressed
// kernel's inline loop; the products are summed in the same order either
// way.
template <typename T, int D, int REP, bool E4M3>
__device__ __forceinline__ void tile_dot(const unsigned char* kt,
                                         const float* sc, const float* sQ,
                                         int key, int part,
                                         float (&dot)[REP]) {
  constexpr int CH = row_bytes<T, D>() / 16;  // 16-byte chunks per row
  constexpr int EPC = 16 / sizeof(T);         // elements per chunk
  constexpr int PARTS = 32 / TK, CP = CH / PARTS;
  constexpr int FCP = D / 16 / PARTS;         // e4m3 chunks per part
  if constexpr (E4M3) {
    const float s = sc[key];
#pragma unroll 2   // fully unrolled, this loop slows both kinds of tile
    for (int jj = 0; jj < FCP; ++jj) {
      const int j = part * FCP + jj;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          kt + chunk_at<T, D>(key, j));
      float kf[16];
      dequant4<T>(raw.x, s, kf);
      dequant4<T>(raw.y, s, kf + 4);
      dequant4<T>(raw.z, s, kf + 8);
      dequant4<T>(raw.w, s, kf + 12);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float* qr = sQ + r * D + j * 16;
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * e4);
          dot[r] = fmaf(qv.x, kf[4 * e4], dot[r]);
          dot[r] = fmaf(qv.y, kf[4 * e4 + 1], dot[r]);
          dot[r] = fmaf(qv.z, kf[4 * e4 + 2], dot[r]);
          dot[r] = fmaf(qv.w, kf[4 * e4 + 3], dot[r]);
        }
      }
    }
  } else {
#pragma unroll
    for (int cc = 0; cc < CP; ++cc) {
      const int c = part * CP + cc;
      float kf[EPC];
      widen(*reinterpret_cast<const uint4*>(kt + chunk_at<T, D>(key, c)), kf,
            static_cast<const T*>(nullptr));
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float* qr = sQ + r * D + c * EPC;
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * e4);
          dot[r] = fmaf(qv.x, kf[4 * e4], dot[r]);
          dot[r] = fmaf(qv.y, kf[4 * e4 + 1], dot[r]);
          dot[r] = fmaf(qv.z, kf[4 * e4 + 2], dot[r]);
          dot[r] = fmaf(qv.w, kf[4 * e4 + 3], dot[r]);
        }
      }
    }
  }
}

// The FP8 instantiations' P V pass: acc += P V over the tile's keys (past
// the length: p = 0, V = 0); lane = columns lane * NE .. + NE of every
// key.  An e4m3 tile's NE codes a row are widened as in tile_dot; a T
// tile runs a copy of the uncompressed kernel's inline loop.
template <typename T, int D, int REP, bool E4M3>
__device__ __forceinline__ void tile_pv(const unsigned char* vt,
                                        const float* sc, const float* sPw,
                                        int lane,
                                        float (&acc)[REP][D / 32]) {
  constexpr int RB = row_bytes<T, D>();
  constexpr int NE = D / 32;
  const int col_byte = lane * NE * (int)sizeof(T);
  const int col8 = lane * NE;              // the same column in e4m3 bytes
#pragma unroll
  for (int j = 0; j < TK; ++j) {
    float vf[NE];
    if constexpr (E4M3)
      load_e4m3<T, NE>(vt + chunk_at<T, D>(j, col8 >> 4) + (col8 & 15),
                       sc[TK + j], vf);
    else
      load_elems<T, NE>(
          vt + j * RB + (((col_byte >> 4) ^ (j & 7)) << 4) + (col_byte & 15),
          vf);
    float pj[REP];
    if constexpr (REP % 4 == 0) {
#pragma unroll
      for (int r4 = 0; r4 < REP / 4; ++r4) {
        const float4 x =
            *reinterpret_cast<const float4*>(sPw + j * REP + 4 * r4);
        pj[4 * r4] = x.x;
        pj[4 * r4 + 1] = x.y;
        pj[4 * r4 + 2] = x.z;
        pj[4 * r4 + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < REP; ++r) pj[r] = sPw[j * REP + r];
    }
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[r][e] = fmaf(pj[r], vf[e], acc[r][e]);
  }
}

// CTAs an SM the split kernel is compiled to fit: two, and for the e4m3
// variant at bf16 and d 64 as many as its uncompressed twin's registers
// and shared memory fit there (four at a group of at most 2, else three).
template <typename T, int D, int REP, bool FP8>
constexpr int min_ctas() {
  if (FP8 && sizeof(T) == 2 && D == 64) return REP <= 2 ? 4 : 3;
  return 2;
}

template <typename T, int D, int REP, bool FP8>
__global__ void __launch_bounds__(NT, (min_ctas<T, D, REP, FP8>()))
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part,
                        float* __restrict__ acc_part, int h, int page_size,
                        int pps, int64_t stride_page, int64_t stride_off,
                        int64_t stride_head, int splits, int split_len,
                        float scale, Fp8Pages f8) {
  using namespace hvd::mma;
  constexpr int RB = row_bytes<T, D>();   // bytes of one key row
  constexpr int CH = RB / 16;             // 16-byte chunks per row
  constexpr int EPC = 16 / sizeof(T);     // elements per chunk
  constexpr int TILE = TK * RB;           // bytes of one K (or V) tile
  constexpr int NE = D / 32;              // P V columns per lane
  extern __shared__ __align__(128) unsigned char dec_smem[];
  float* sQ = reinterpret_cast<float*>(dec_smem + NW * STAGES * 2 * TILE);
  float* sP = sQ + REP * D;               // [NW][TK][REP]

  // Flat grid, split slowest: the live low splits are dispatched first.
  const int h_kv = h / REP;
  const int per_split = gridDim.x / splits;       // slots * h_kv
  const int split = blockIdx.x / per_split;
  const int slot = (blockIdx.x % per_split) / h_kv;
  const int kvh = blockIdx.x % h_kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Lengths past the slot's capacity see the whole slot, as the
  // reference's arange(s) < lengths mask does.
  const int len = min(lengths[slot], pps * page_size);
  const int start = split * split_len;
  if (start >= len) return;   // nothing live: the merge never reads it
  const int end = min(len, start + split_len);

  const T* qb = q + ((size_t)slot * h + (size_t)kvh * REP) * D;
  for (int i = tid; i < REP * D; i += NT) sQ[i] = hvd::to_float(qb[i]);

  // This warp's tiles: w, w + NW, ... of the split's 16-key tiles.
  const int n_all = (end - start + TK - 1) / TK;
  const int n_mine = warp < n_all ? (n_all - warp + NW - 1) / NW : 0;
  const uint32_t ring = smem_addr(dec_smem) + warp * STAGES * 2 * TILE;
  unsigned char* ring_p = dec_smem + warp * STAGES * 2 * TILE;
  const size_t head_off = (size_t)kvh * stride_head;
  const int* slot_pages = page_table ? page_table + (size_t)slot * pps
                                     : nullptr;
  const int* slot_cpages = FP8 ? f8.ctable + (size_t)slot * pps : nullptr;
  const uint8_t* slot_cmask = FP8 ? f8.cmask + (size_t)slot * pps : nullptr;
  // FP8: this warp's [STAGES][2][TK] scales after sP, the row bits of
  // tiles i and i + 1, and the lookups of tile i + STAGES - 1.
  const float* sSc = sP + NW * TK * REP + warp * STAGES * 2 * TK;
  uint32_t rows_a = 0, rows_b = 0;
  RowPages ahead{0, 0, 0};
  if constexpr (FP8) {
    static_assert(STAGES == 3, "the FP8 ring rotates two row masks");
    RowPages rp = look_up(slot_pages, slot_cpages, slot_cmask, page_size,
                          start + warp * TK, end, lane);
#pragma unroll 1   // one copy of the loader's code: it is fetched cold
    for (int i = 0; i < STAGES - 1; ++i) {
      const RowPages nx =
          look_up(slot_pages, slot_cpages, slot_cmask, page_size,
                  start + (warp + (i + 1) * NW) * TK, end, lane);
      uint32_t rows = 0;
      if (i < n_mine)
        rows = load_tile_fp8<T, D>(
            k, v, f8, rp, page_size, stride_page, stride_off, head_off,
            start + (warp + i * NW) * TK, end, ring + i * 2 * TILE,
            smem_addr(sSc + i * 2 * TK), lane);
      cp_async_commit();
      rows_a = rows_b;
      rows_b = rows;
      rp = nx;
    }
    ahead = rp;
  } else {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_mine)
        load_tile<T, D>(k, v, slot_pages, slot, page_size, stride_page,
                        stride_off, head_off, start + (warp + i * NW) * TK,
                        end, ring + i * 2 * TILE, lane);
      cp_async_commit();
    }
  }
  __syncthreads();  // q visible

  float acc[REP][NE];
  float m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0.f;
  }
  // Score pass: lane = (key lane % TK, part lane / TK of the row).  P V
  // pass: lane = columns lane * NE .. + NE of every key.
  constexpr int PARTS = 32 / TK, CP = CH / PARTS;
  const int key = lane % TK, part = lane / TK;
  const int col_byte = lane * NE * (int)sizeof(T);
  float* sPw = sP + warp * TK * REP;

  for (int i = 0; i < n_mine; ++i) {
    uint32_t rows_c = 0;
    if constexpr (FP8) {
      const int t = i + STAGES - 1;
      if (t < n_mine)
        rows_c = load_tile_fp8<T, D>(
            k, v, f8, ahead, page_size, stride_page, stride_off, head_off,
            start + (warp + t * NW) * TK, end,
            ring + t % STAGES * 2 * TILE,
            smem_addr(sSc + t % STAGES * 2 * TK), lane);
      ahead = look_up(slot_pages, slot_cpages, slot_cmask, page_size,
                      start + (warp + (t + 1) * NW) * TK, end, lane);
    } else {
      if (i + STAGES - 1 < n_mine)
        load_tile<T, D>(k, v, slot_pages, slot, page_size, stride_page,
                        stride_off, head_off,
                        start + (warp + (i + STAGES - 1) * NW) * TK, end,
                        ring + (i + STAGES - 1) % STAGES * 2 * TILE, lane);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // tile i has landed for every lane of the warp
    const unsigned char* kt = ring_p + (i % STAGES) * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    const int k0 = start + (warp + i * NW) * TK;
    const float* sc = sSc + (i % STAGES) * 2 * TK;
    if constexpr (FP8) {
      if (rows_a != 0 && rows_a != ALL_ROWS) {
        widen_rows<T, D>(ring_p + (i % STAGES) * 2 * TILE, sc, rows_a, lane);
        rows_a = 0;
      }
    }

    float dot[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) dot[r] = 0.f;
    if constexpr (FP8) {
      if (rows_a == ALL_ROWS)
        tile_dot<T, D, REP, true>(kt, sc, sQ, key, part, dot);
      else
        tile_dot<T, D, REP, false>(kt, sc, sQ, key, part, dot);
    } else {
#pragma unroll
      for (int cc = 0; cc < CP; ++cc) {
        const int c = part * CP + cc;
        float kf[EPC];
        widen(*reinterpret_cast<const uint4*>(kt + chunk_at<T, D>(key, c)),
              kf, static_cast<const T*>(nullptr));
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float* qr = sQ + r * D + c * EPC;
#pragma unroll
          for (int e4 = 0; e4 < EPC / 4; ++e4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * e4);
            dot[r] = fmaf(qv.x, kf[4 * e4], dot[r]);
            dot[r] = fmaf(qv.y, kf[4 * e4 + 1], dot[r]);
            dot[r] = fmaf(qv.z, kf[4 * e4 + 2], dot[r]);
            dot[r] = fmaf(qv.w, kf[4 * e4 + 3], dot[r]);
          }
        }
      }
    }
    const bool live = k0 + key < end;   // key 0 of every tile is live
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float s = dot[r];
#pragma unroll
      for (int o = TK; o < 32; o <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      s = live ? s * scale : -INFINITY;
      // Lanes l, l ^ TK, ... hold the same key: reduce over TK lanes.
      float mx = s, ps;
#pragma unroll
      for (int o = TK / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      ps = p;
#pragma unroll
      for (int o = TK / 2; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = alpha * l[r] + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[r][e] *= alpha;
      if (part == 0) sPw[key * REP + r] = p;
    }
    __syncwarp();  // the tile's P is in shared memory

    // acc += P V over the tile's keys (past the length: p = 0, V = 0).
    if constexpr (FP8) {
      if (rows_a == ALL_ROWS)
        tile_pv<T, D, REP, true>(vt, sc, sPw, lane, acc);
      else
        tile_pv<T, D, REP, false>(vt, sc, sPw, lane, acc);
      rows_a = rows_b;
      rows_b = rows_c;
    } else {
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        float vf[NE];
        load_elems<T, NE>(
            vt + j * RB + (((col_byte >> 4) ^ (j & 7)) << 4) + (col_byte & 15),
            vf);
        float pj[REP];
        if constexpr (REP % 4 == 0) {
#pragma unroll
          for (int r4 = 0; r4 < REP / 4; ++r4) {
            const float4 x =
                *reinterpret_cast<const float4*>(sPw + j * REP + 4 * r4);
            pj[4 * r4] = x.x;
            pj[4 * r4 + 1] = x.y;
            pj[4 * r4 + 2] = x.z;
            pj[4 * r4 + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < REP; ++r) pj[r] = sPw[j * REP + r];
        }
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int e = 0; e < NE; ++e)
            acc[r][e] = fmaf(pj[r], vf[e], acc[r][e]);
      }
    }
    __syncwarp();  // every lane is done with this stage and with sPw
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it below

  // Log-sum-exp merge of the 4 warps (a warp with no tile has m = -inf,
  // l = 0, acc = 0 and adds nothing; warp 0 always has a live key).
  float* sM = reinterpret_cast<float*>(dec_smem);   // [NW][REP]
  float* sL = sM + NW * REP;                         // [NW][REP]
  float* sAcc = sL + NW * REP;                       // [NW][REP][D]
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sM[warp * REP + r] = m[r];
      sL[warp * REP + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < NE; ++e)
      sAcc[(warp * REP + r) * D + lane * NE + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = tid; idx < REP * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sM[w * REP + r]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(sM[w * REP + r] - mx);
      a += wt * sAcc[(w * REP + r) * D + d];
      lsum += wt * sL[w * REP + r];
    }
    const size_t row =
        ((size_t)slot * h + (size_t)kvh * REP + r) * splits + split;
    acc_part[row * D + d] = a;
    if (d == 0) {
      m_part[row] = mx;
      l_part[row] = lsum;
    }
  }
}

// Log-sum-exp merge of a slot's live splits: one CTA per (query head,
// slot), one thread per head_dim element.  A slot with no live key gives
// exactly 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_merge_kernel(const float* __restrict__ m_part,
                        const float* __restrict__ l_part,
                        const float* __restrict__ acc_part,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        int h, int splits, int split_len, int capacity) {
  const int hh = blockIdx.x, slot = blockIdx.y, d = threadIdx.x;
  const size_t row0 = ((size_t)slot * h + hh) * splits;
  const int len = max(0, min(lengths[slot], capacity));
  const int live = (len + split_len - 1) / split_len;
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, m_part[row0 + s]);
  float out = 0.f;
  if (live > 0) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = expf(m_part[row0 + s] - mx);
      lsum += w * l_part[row0 + s];
      a += w * acc_part[(row0 + s) * D + d];
    }
    out = a / lsum;
  }
  o[((size_t)slot * h + hh) * D + d] = hvd::from_float<T>(out);
}

// The split kernel's dynamic shared memory opt-in, once per instantiation.
template <typename T, int D, int REP, bool FP8>
cudaError_t configure() {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D, REP, FP8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, D, REP, FP8>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

// The arguments every entry point passes through to launch().
struct Args {
  const void *q, *k, *v, *page_table, *lengths;
  void *o, *m_part, *l_part, *acc_part;
  int slots, h, h_kv, page_size, pps;
  int64_t stride_page, stride_off, stride_head;
  int splits, split_len;
  float scale;
  Fp8Pages f8;
  cudaStream_t stream;
};

template <typename T, int D, int REP, bool FP8>
cudaError_t launch(const Args& a) {
  cudaError_t err = configure<T, D, REP, FP8>();
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, D, REP, FP8><<<a.splits * a.slots * a.h_kv, NT,
                                        smem_bytes<T, D, REP, FP8>(),
                                        a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.m_part),
      static_cast<float*>(a.l_part), static_cast<float*>(a.acc_part), a.h,
      a.page_size, a.pps, a.stride_page, a.stride_off, a.stride_head,
      a.splits, a.split_len, a.scale, a.f8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<dim3(a.h, a.slots), D, 0, a.stream>>>(
      static_cast<const float*>(a.m_part),
      static_cast<const float*>(a.l_part),
      static_cast<const float*>(a.acc_part),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.o), a.h,
      a.splits, a.split_len, a.pps * a.page_size);
  return cudaGetLastError();
}

struct Launch {
  const Args& a;
  template <typename T, int D, int REP, bool FP8>
  cudaError_t run() const {
    return launch<T, D, REP, FP8>(a);
  }
};

// The split kernel's registers a thread, dynamic shared memory a CTA and
// CTAs an SM, as the runtime reports them.
struct Resources {
  int* out;
  template <typename T, int D, int REP, bool FP8>
  cudaError_t run() const {
    cudaError_t err = configure<T, D, REP, FP8>();
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, decode_split_kernel<T, D, REP, FP8>);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = (int)smem_bytes<T, D, REP, FP8>();
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], decode_split_kernel<T, D, REP, FP8>, NT, out[1]);
  }
};

template <typename T, int D, bool FP8, typename Op>
cudaError_t by_rep(const Op& op, int rep) {
  switch (rep) {
    case 1:
      return op.template run<T, D, 1, FP8>();
    case 2:
      return op.template run<T, D, 2, FP8>();
    case 4:
      return op.template run<T, D, 4, FP8>();
    case 8:
      return op.template run<T, D, 8, FP8>();
  }
  return cudaErrorInvalidValue;
}

// op.run<T, D, REP, FP8>() for the instantiation that serves (d, dtype,
// rep).
template <bool FP8, typename Op>
int by_type(const Op& op, int d, int dtype, int rep) {
  if (dtype == hvd::kBF16 && d == 128)
    return (int)by_rep<__nv_bfloat16, 128, FP8>(op, rep);
  if (dtype == hvd::kBF16 && d == 64)
    return (int)by_rep<__nv_bfloat16, 64, FP8>(op, rep);
  if (dtype == hvd::kF32 && d == 128)
    return (int)by_rep<float, 128, FP8>(op, rep);
  if (dtype == hvd::kF32 && d == 64)
    return (int)by_rep<float, 64, FP8>(op, rep);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int hvd_flash_decode(const void* q, const void* k, const void* v,
                                const void* page_table, const void* lengths,
                                void* o, void* m_part, void* l_part,
                                void* acc_part, int slots, int h, int h_kv,
                                int d, int page_size, int pps,
                                int64_t stride_page, int64_t stride_off,
                                int64_t stride_head, int splits,
                                int split_len, int dtype, float scale,
                                void* stream) {
  const Args a{q, k, v, page_table, lengths, o, m_part, l_part, acc_part,
               slots, h, h_kv, page_size, pps, stride_page, stride_off,
               stride_head, splits, split_len, scale, Fp8Pages{},
               static_cast<cudaStream_t>(stream)};
  return by_type<false>(Launch{a}, d, dtype, h / h_kv);
}

// The same over a paged pool of which the pages cmask marks live in the
// e4m3 pool kq/vq at ctable's page, with one f32 scale a row (kscale,
// vscale: [pages, page_size]).  cmask is one byte per [slot, page].
extern "C" int hvd_flash_decode_fp8(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* lengths, const void* kq, const void* vq, const void* kscale,
    const void* vscale, const void* ctable, const void* cmask, void* o,
    void* m_part, void* l_part, void* acc_part, int slots, int h, int h_kv,
    int d, int page_size, int pps, int64_t stride_page, int64_t stride_off,
    int64_t stride_head, int splits, int split_len, int dtype, float scale,
    void* stream) {
  if (page_table == nullptr) return (int)cudaErrorInvalidValue;
  const Fp8Pages f8{static_cast<const uint8_t*>(kq),
                    static_cast<const uint8_t*>(vq),
                    static_cast<const float*>(kscale),
                    static_cast<const float*>(vscale),
                    static_cast<const int*>(ctable),
                    static_cast<const uint8_t*>(cmask)};
  const Args a{q, k, v, page_table, lengths, o, m_part, l_part, acc_part,
               slots, h, h_kv, page_size, pps, stride_page, stride_off,
               stride_head, splits, split_len, scale, f8,
               static_cast<cudaStream_t>(stream)};
  return by_type<true>(Launch{a}, d, dtype, h / h_kv);
}

// out[0..2]: the split kernel's registers a thread, dynamic shared memory
// a CTA (bytes) and CTAs an SM for (d, dtype, rep), over one pool (fp8 =
// 0) or with e4m3 pages (fp8 = 1).
extern "C" int hvd_flash_decode_resources(int d, int dtype, int rep,
                                          int fp8, int* out) {
  const Resources op{out};
  return fp8 ? by_type<true>(op, d, dtype, rep)
             : by_type<false>(op, d, dtype, rep);
}
