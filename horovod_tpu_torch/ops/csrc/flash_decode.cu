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
// scratch page and is never read.  load_tile reads such a row's e4m3
// bytes with plain loads, forms f32(e4m3) * scale, rounds it to the pool
// type T (the reference's .astype(view.dtype)) and stores it into the
// same swizzled tile slot the cp.async of a T row fills.  From there on
// the two variants run the same code, so a step over compressed pages is
// bitwise the uncompressed kernel over a pool holding the dequantised
// rows.  The uncompressed instantiations (FP8 = false) compile the same
// instructions as before: every fp8 branch is `if constexpr`.

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

template <typename T, int D, int REP>
constexpr size_t smem_bytes() {
  return (size_t)NW * STAGES * 2 * TK * row_bytes<T, D>() +
         sizeof(float) * (REP * D + NW * TK * REP);
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

// The 16/sizeof(T) e4m3 codes at `src` times `s`, each product rounded to
// T, stored as one 16-byte chunk at shared address `dst`.
__device__ __forceinline__ void store_dequant(unsigned char* dst,
                                              const uint8_t* src, float s,
                                              const float*) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
  const float2 a = e4m3x2(w & 0xffffu), b = e4m3x2(w >> 16);
  *reinterpret_cast<float4*>(dst) = make_float4(
      __fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(b.x, s),
      __fmul_rn(b.y, s));
}

__device__ __forceinline__ void store_dequant(unsigned char* dst,
                                              const uint8_t* src, float s,
                                              const __nv_bfloat16*) {
  const uint2 w = *reinterpret_cast<const uint2*>(src);
  const uint32_t words[2] = {w.x, w.y};
  uint4 raw;
  uint32_t* out = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = e4m3x2(words[i] & 0xffffu), b = e4m3x2(words[i] >> 16);
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(__fmul_rn(b.x, s), __fmul_rn(b.y, s));
    out[2 * i] = *reinterpret_cast<const uint32_t*>(&lo);
    out[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
  *reinterpret_cast<uint4*>(dst) = raw;
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

// One warp's K and V tile of keys [k0, k0 + TK) into the ring stage at
// shared address `dst` (K, then V TILE bytes later; `dst_p` the same
// stage as a generic pointer): 16-byte cp.async copies, zero-filled at
// and past `end`.  Lane l looks up the page of key l % 16 once (one page
// per slot when there is no table); the lanes that copy a row's chunks
// take its offset by shuffle.  With FP8, a row on a compressed page is
// dequantised into its chunks instead (store_dequant).
template <typename T, int D, bool FP8>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ slot_pages, int slot, int page_size,
    int64_t stride_page, int64_t stride_off, size_t head_off, int k0,
    int end, uint32_t dst, unsigned char* dst_p, int lane,
    const Fp8Pages& f8, const int* __restrict__ slot_cpages,
    const uint8_t* __restrict__ slot_cmask) {
  constexpr int CH = row_bytes<T, D>() / 16;
  constexpr int EPC = 16 / sizeof(T);
  constexpr uint32_t TILE = TK * row_bytes<T, D>();
  const int pos = k0 + (lane & (TK - 1));
  unsigned long long mine = 0;
  int comp = 0;
  float ks = 0.f, vs = 0.f;
  if (pos < end) {
    int page;
    if constexpr (FP8) {
      const int pi = pos / page_size;
      comp = slot_cmask[pi];
      page = comp ? slot_cpages[pi] : slot_pages[pi];
      if (comp) {
        const size_t row = (size_t)page * page_size + pos % page_size;
        ks = f8.kscale[row];
        vs = f8.vscale[row];
      }
    } else {
      page = slot_pages ? slot_pages[pos / page_size] : slot;
    }
    mine = (size_t)page * stride_page +
           (size_t)(pos % page_size) * stride_off + head_off;
  }
#pragma unroll
  for (int it = 0; it < TK * CH / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / CH, c = idx % CH;
    const size_t off = __shfl_sync(0xffffffffu, mine, r);
    const bool ok = k0 + r < end;
    const uint32_t at = dst + chunk_at<T, D>(r, c);
    if constexpr (FP8) {
      const int rc = __shfl_sync(0xffffffffu, comp, r);
      const float rks = __shfl_sync(0xffffffffu, ks, r);
      const float rvs = __shfl_sync(0xffffffffu, vs, r);
      if (rc) {   // set on live rows only
        unsigned char* p = dst_p + chunk_at<T, D>(r, c);
        store_dequant(p, f8.kq + off + EPC * c, rks,
                      static_cast<const T*>(nullptr));
        store_dequant(p + TILE, f8.vq + off + EPC * c, rvs,
                      static_cast<const T*>(nullptr));
        continue;
      }
    }
    hvd::mma::cp_async16(
        at, reinterpret_cast<const unsigned char*>(k + off) + 16 * c, ok);
    hvd::mma::cp_async16(
        at + TILE, reinterpret_cast<const unsigned char*>(v + off) + 16 * c,
        ok);
  }
}

template <typename T, int D, int REP, bool FP8>
__global__ void __launch_bounds__(NT, 2)
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
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_mine)
      load_tile<T, D, FP8>(k, v, slot_pages, slot, page_size, stride_page,
                           stride_off, head_off,
                           start + (warp + i * NW) * TK, end,
                           ring + i * 2 * TILE, ring_p + i * 2 * TILE,
                           lane, f8, slot_cpages, slot_cmask);
    cp_async_commit();
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
    if (i + STAGES - 1 < n_mine)
      load_tile<T, D, FP8>(k, v, slot_pages, slot, page_size, stride_page,
                           stride_off, head_off,
                           start + (warp + (i + STAGES - 1) * NW) * TK, end,
                           ring + (i + STAGES - 1) % STAGES * 2 * TILE,
                           ring_p + (i + STAGES - 1) % STAGES * 2 * TILE,
                           lane, f8, slot_cpages, slot_cmask);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // tile i has landed for every lane of the warp
    const unsigned char* kt = ring_p + (i % STAGES) * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    const int k0 = start + (warp + i * NW) * TK;

    float dot[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) dot[r] = 0.f;
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
        for (int e = 0; e < NE; ++e) acc[r][e] = fmaf(pj[r], vf[e], acc[r][e]);
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

template <typename T, int D, int REP, bool FP8>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* page_table, const void* lengths, void* o,
                   void* m_part, void* l_part, void* acc_part, int slots,
                   int h, int h_kv, int page_size, int pps,
                   int64_t stride_page, int64_t stride_off,
                   int64_t stride_head, int splits, int split_len,
                   float scale, const Fp8Pages& f8, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, REP>();
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D, REP, FP8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  decode_split_kernel<T, D, REP, FP8><<<splits * slots * h_kv, NT, smem,
                                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), h,
      page_size, pps, stride_page, stride_off, stride_head, splits,
      split_len, scale, f8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<dim3(h, slots), D, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<const int*>(lengths),
      static_cast<T*>(o), h, splits, split_len, pps * page_size);
  return cudaGetLastError();
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
cudaError_t launch_args(const Args& a) {
  return launch<T, D, REP, FP8>(
      a.q, a.k, a.v, a.page_table, a.lengths, a.o, a.m_part, a.l_part,
      a.acc_part, a.slots, a.h, a.h_kv, a.page_size, a.pps, a.stride_page,
      a.stride_off, a.stride_head, a.splits, a.split_len, a.scale, a.f8,
      a.stream);
}

template <typename T, int D, bool FP8>
cudaError_t by_rep(const Args& a) {
  switch (a.h / a.h_kv) {
    case 1:
      return launch_args<T, D, 1, FP8>(a);
    case 2:
      return launch_args<T, D, 2, FP8>(a);
    case 4:
      return launch_args<T, D, 4, FP8>(a);
    case 8:
      return launch_args<T, D, 8, FP8>(a);
  }
  return cudaErrorInvalidValue;
}

template <bool FP8>
int by_type(const Args& a, int d, int dtype) {
  if (dtype == hvd::kBF16 && d == 128)
    return (int)by_rep<__nv_bfloat16, 128, FP8>(a);
  if (dtype == hvd::kBF16 && d == 64)
    return (int)by_rep<__nv_bfloat16, 64, FP8>(a);
  if (dtype == hvd::kF32 && d == 128) return (int)by_rep<float, 128, FP8>(a);
  if (dtype == hvd::kF32 && d == 64) return (int)by_rep<float, 64, FP8>(a);
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
  return by_type<false>(a, d, dtype);
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
  return by_type<true>(a, d, dtype);
}
