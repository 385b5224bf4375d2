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
// card's balance point, so the floor is bytes / 3.35 TB/s.  The design
// goes after bytes and parallelism:
//   * one CTA per (KV split, kv head, slot); its warps are the rep query
//     heads of the group, so every K/V tile is loaded once for all of
//     them (the TPU kernel's (rep, d) tile, in shared memory here);
//   * the sequence is cut into splits so that 8 slots x 8 kv heads fill
//     the 132 SMs several times over; tiles past a slot's length are
//     never read, so the bytes moved track sum(lengths), not capacity;
//   * 16-byte vector loads along head_dim (a key row is d contiguous
//     elements in the pool), converted to f32 once in shared memory;
//   * each split keeps its running max / normalizer / accumulator in
//     registers and writes them as partials; blocks carry nothing between
//     them, so a second small kernel merges the partials by log-sum-exp
//     (the step the TPU kernel did on its sequential grid axis).
// Keys at or past the length are masked in the kernel, so recycled-page
// garbage (any finite value) never contributes.  Both launches allocate
// nothing: the partials are scratch the caller passes in.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int TK = 32;  // keys per tile (one per lane)

template <int D, int REP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (REP * D + TK * (D + 4) + TK * D + REP * TK);
}

template <typename T, int D, int REP>
__global__ void __launch_bounds__(32 * REP)
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
  constexpr int NT = 32 * REP;
  constexpr int SD = D + 4;
  constexpr int CH = D / 8;
  constexpr int NA = D / 32;  // output elements per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [REP][D]
  float* sK = sQ + REP * D;     // [TK][SD]
  float* sV = sK + TK * SD;     // [TK][D]
  float* sP = sV + TK * D;      // [REP][TK]

  const int split = blockIdx.x, kvh = blockIdx.y, slot = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Lengths past the slot's capacity see the whole slot, as the
  // reference's arange(s) < lengths mask does.
  const int len = min(lengths[slot], pps * page_size);
  const int start = split * split_len;
  const int end = min(len, start + split_len);

  const T* qb = q + ((size_t)slot * h + (size_t)kvh * REP) * D;
  for (int i = tid; i < REP * CH; i += NT) hvd::load8(qb + i * 8, sQ + i * 8);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = start; k0 < end; k0 += TK) {
    __syncthreads();  // q visible / previous tile's readers done
    for (int i = tid; i < TK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const int pos = k0 + r;
      if (pos < end) {
        const int page =
            page_table ? page_table[slot * pps + pos / page_size] : slot;
        const size_t base = (size_t)page * stride_page +
                            (size_t)(pos % page_size) * stride_off +
                            (size_t)kvh * stride_head + c;
        hvd::load8(k + base, sK + r * SD + c);
        hvd::load8(v + base, sV + r * D + c);
      } else {
        hvd::zero8(sK + r * SD + c);
        hvd::zero8(sV + r * D + c);
      }
    }
    __syncthreads();

    // Warp = query head of the group, lane = key of the tile.
    const int pos = k0 + lane;
    float s = -INFINITY;
    if (pos < end) {
      float dot = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; kk += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + warp * D + kk);
        const float4 kv = *reinterpret_cast<const float4*>(sK + lane * SD + kk);
        dot = fmaf(qv.x, kv.x, dot);
        dot = fmaf(qv.y, kv.y, dot);
        dot = fmaf(qv.z, kv.z, dot);
        dot = fmaf(qv.w, kv.w, dot);
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, hvd::warp_max(s));  // lane 0 is live
    const float p = (pos < end) ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = alpha * l + hvd::warp_sum(p);
    m = m_new;
    sP[warp * TK + lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha;
    const int nkeys = min(TK, end - k0);
    for (int j = 0; j < nkeys; ++j) {
      const float pj = sP[warp * TK + j];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        acc[i] = fmaf(pj, sV[j * D + lane + 32 * i], acc[i]);
    }
    __syncwarp();
  }

  const size_t row =
      ((size_t)slot * h + (size_t)kvh * REP + warp) * splits + split;
  if (lane == 0) {
    m_part[row] = m;  // -inf and l = 0 for a split with no live key
    l_part[row] = l;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) acc_part[row * D + lane + 32 * i] = acc[i];
}

// Log-sum-exp merge of the splits: one CTA per (query head, slot), one
// thread per head_dim element.  A slot with no live key gives exactly 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_merge_kernel(const float* __restrict__ m_part,
                        const float* __restrict__ l_part,
                        const float* __restrict__ acc_part,
                        T* __restrict__ o, int h, int splits) {
  const int hh = blockIdx.x, slot = blockIdx.y, d = threadIdx.x;
  const size_t row0 = ((size_t)slot * h + hh) * splits;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[row0 + s]);
  float out = 0.f;
  if (mx > -INFINITY) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
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
  const dim3 grid(splits, h_kv, slots);
  decode_split_kernel<T, D, REP><<<grid, 32 * REP, smem_bytes<D, REP>(),
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
      static_cast<const float*>(acc_part), static_cast<T*>(o), h, splits);
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
