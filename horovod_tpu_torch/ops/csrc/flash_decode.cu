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

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NW = 4;          // warps per CTA
constexpr int NT = 32 * NW;
constexpr int TK = 16;         // keys per warp tile
constexpr int STAGES = 3;      // ring depth per warp

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
// shared address `dst` (K, then V TILE bytes later): 16-byte cp.async
// copies, zero-filled at and past `end`.  Lane l looks up the page of key
// l % 16 once (one page per slot when there is no table); the lanes that
// copy a row's chunks take its offset by shuffle.
template <typename T, int D>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ slot_pages, int slot, int page_size,
    int64_t stride_page, int64_t stride_off, size_t head_off, int k0,
    int end, uint32_t dst, int lane) {
  constexpr int CH = row_bytes<T, D>() / 16;
  constexpr uint32_t TILE = TK * row_bytes<T, D>();
  const int pos = k0 + (lane & (TK - 1));
  unsigned long long mine = 0;
  if (pos < end) {
    const int page = slot_pages ? slot_pages[pos / page_size] : slot;
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
    hvd::mma::cp_async16(
        at, reinterpret_cast<const unsigned char*>(k + off) + 16 * c, ok);
    hvd::mma::cp_async16(
        at + TILE, reinterpret_cast<const unsigned char*>(v + off) + 16 * c,
        ok);
  }
}

template <typename T, int D, int REP>
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
                        float scale) {
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
  const unsigned char* ring_p = dec_smem + warp * STAGES * 2 * TILE;
  const size_t head_off = (size_t)kvh * stride_head;
  const int* slot_pages = page_table ? page_table + (size_t)slot * pps
                                     : nullptr;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_mine)
      load_tile<T, D>(k, v, slot_pages, slot, page_size, stride_page,
                      stride_off, head_off,
                      start + (warp + i * NW) * TK, end,
                      ring + i * 2 * TILE, lane);
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
      load_tile<T, D>(k, v, slot_pages, slot, page_size, stride_page,
                      stride_off, head_off,
                      start + (warp + (i + STAGES - 1) * NW) * TK, end,
                      ring + (i + STAGES - 1) % STAGES * 2 * TILE, lane);
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

template <typename T, int D, int REP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* page_table, const void* lengths, void* o,
                   void* m_part, void* l_part, void* acc_part, int slots,
                   int h, int h_kv, int page_size, int pps,
                   int64_t stride_page, int64_t stride_off,
                   int64_t stride_head, int splits, int split_len,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, REP>();
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D, REP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  decode_split_kernel<T, D, REP><<<splits * slots * h_kv, NT, smem,
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), h,
      page_size, pps, stride_page, stride_off, stride_head, splits,
      split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<dim3(h, slots), D, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<const int*>(lengths),
      static_cast<T*>(o), h, splits, split_len, pps * page_size);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rep(int rep, const void* q, const void* k, const void* v,
                   const void* pt, const void* len, void* o, void* mp,
                   void* lp, void* ap, int slots, int h, int h_kv, int ps,
                   int pps, int64_t sp, int64_t so, int64_t sh, int splits,
                   int split_len, float scale, cudaStream_t s) {
  switch (rep) {
    case 1:
      return launch<T, D, 1>(q, k, v, pt, len, o, mp, lp, ap, slots, h,
                             h_kv, ps, pps, sp, so, sh, splits, split_len,
                             scale, s);
    case 2:
      return launch<T, D, 2>(q, k, v, pt, len, o, mp, lp, ap, slots, h,
                             h_kv, ps, pps, sp, so, sh, splits, split_len,
                             scale, s);
    case 4:
      return launch<T, D, 4>(q, k, v, pt, len, o, mp, lp, ap, slots, h,
                             h_kv, ps, pps, sp, so, sh, splits, split_len,
                             scale, s);
    case 8:
      return launch<T, D, 8>(q, k, v, pt, len, o, mp, lp, ap, slots, h,
                             h_kv, ps, pps, sp, so, sh, splits, split_len,
                             scale, s);
  }
  return cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = h / h_kv;
  if (dtype == hvd::kBF16 && d == 128)
    return by_rep<__nv_bfloat16, 128>(rep, q, k, v, page_table, lengths, o,
                                      m_part, l_part, acc_part, slots, h,
                                      h_kv, page_size, pps, stride_page,
                                      stride_off, stride_head, splits,
                                      split_len, scale, s);
  if (dtype == hvd::kBF16 && d == 64)
    return by_rep<__nv_bfloat16, 64>(rep, q, k, v, page_table, lengths, o,
                                     m_part, l_part, acc_part, slots, h,
                                     h_kv, page_size, pps, stride_page,
                                     stride_off, stride_head, splits,
                                     split_len, scale, s);
  if (dtype == hvd::kF32 && d == 128)
    return by_rep<float, 128>(rep, q, k, v, page_table, lengths, o, m_part,
                              l_part, acc_part, slots, h, h_kv, page_size,
                              pps, stride_page, stride_off, stride_head,
                              splits, split_len, scale, s);
  if (dtype == hvd::kF32 && d == 64)
    return by_rep<float, 64>(rep, q, k, v, page_table, lengths, o, m_part,
                             l_part, acc_part, slots, h, h_kv, page_size,
                             pps, stride_page, stride_off, stride_head,
                             splits, split_len, scale, s);
  return (int)cudaErrorInvalidValue;
}
