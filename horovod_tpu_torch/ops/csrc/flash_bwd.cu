// FlashAttention-2 backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces: horovod_tpu/ops/attention.py::_flash_bwd, whose two Pallas TPU
// kernels are _dq_kernel (dq, accumulated over kv blocks) and _dkv_kernel
// (dk/dv, accumulated over q blocks per QUERY head in f32 and summed over
// each GQA group outside the kernel).  Same function, to the conventions of
// flash_fwd.cu: p = exp(s * scale - lse) is recomputed from the forward's
// logsumexp, delta = rowsum(dO * O) comes in precomputed (the JAX package
// also computes it outside its kernels), ds = p * (dp - delta) * scale with
// dp = dO V^T; causal masking is bottom-right (query i sits at absolute
// position tk - tq + i), segment ids mask unequal pairs, GQA reads kv head
// h / rep in place, and a DEAD row (lse = +1e30) gets p = 0 everywhere, so
// its gradients are exactly 0.  Masked pairs take p = 0 outright.  Inputs
// are f32 or bf16; every sum accumulates in f32.
//
// What bounds it on the H100: at the training shape (b=2, h=32, h_kv=8,
// t=2048, d=128, causal) dq does 3 products per kept pair and head (s, dp,
// ds K) and dk/dv 4 (s, dp, p^T dO, ds^T Q): 103 and 137 GFLOP against
// ~100 MB of q/k/v/dO/dq/dk/dv, far above the card's ~295 FLOP/byte balance
// point, so both are bound by arithmetic (104 and 139 us at the 989 TFLOP/s
// bf16 tensor-core peak).  What the designs do instead of the TPU's
// sequential grid: the Pallas kernels carry dq (or dk/dv) in VMEM scratch
// across a sequential grid axis; GPU blocks run in no order and carry
// nothing, so each CTA loops over the other sequence itself and keeps its
// sums in registers.  dk/dv are summed over the GQA group inside the CTA
// and written once in k's dtype, replacing the JAX design's f32
// per-query-head partials (2 x 67 MB at the training shape) and its group
// sum outside the kernel; there are no atomics, so results repeat bit for
// bit.  The ragged edge (any tq, any tk) is masked in the kernel: rows and
// keys past the end load as zero, take p = 0 and are not stored.  There is
// no fallback to a plain path for any length.
//
// dk/dv, bf16 -- flash_bwd_dkv_mma_kernel, on the tensor cores (mma.sync
// m16n8k16, f32 accumulators; mma.cuh):
//   * one CTA per (batch, KV head, 64 keys), 8 warps; K and V stay resident
//     in shared memory; the CTA loops over the rep query heads of the group
//     and the 64-row query tiles that can see its keys, with Q, dO, lse,
//     delta and the query segment ids in a 2-stage cp.async ring
//     (XOR-swizzled rows: conflict-free cp.async and ldmatrix); 121.5 KB
//     at d = 128, one CTA an SM;
//   * S^T = K Q^T and dP^T = V dO^T on the tensor cores; then
//     P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale in
//     f32 on the fragments, written to shared memory as bf16 -- P^T once,
//     dS^T in two parts, hi = bf16(dS^T) and lo = bf16(dS^T - hi) (the
//     only roundings: every sum stays f32); then dV += P^T dO and
//     dK += dS^T Q as hi Q + lo Q, dK and dV split over the 8 warps (16
//     keys x d/2 columns each) in f32 registers for the whole loop;
//   * precision: dS sums to zero over each query's keys, so a component
//     every key shares cancels out of dq, and since the dk rows then sum
//     to zero, a component every input of the key projection shares
//     cancels out of its weights' gradient.  Where such a component is
//     large -- BERT's second layer, after a near-uniform bidirectional
//     attention, in chip_smoke.py's bert_grad phase -- the true gradient
//     is the small remainder, and one bf16 rounding of dS (2^-9 of each
//     element, no longer summing to zero) leaks into it uncancelled, to
//     several times the plain bf16 path's error (PERF.md, PR 8).  hi + lo
//     carries dS to ~16 bits, at one more product;
//   * key block 0, which the most query tiles see under the causal mask, is
//     dispatched first.
//
// dq, bf16 -- flash_bwd_dq_mma_kernel, on the tensor cores:
//   * one CTA per (batch, query head, 128 query rows), 8 warps of 16 rows;
//     CTAs of the last query tiles (the most causal work) launch first;
//     Q and dO stay resident in swizzled shared memory, lse and delta in
//     registers; K/V stream as 64-key tiles through a 2-stage cp.async
//     ring (the next tile loads while this one is used); 128.5 KB at
//     d = 128, one CTA an SM;
//   * S = Q K^T and dP = dO V^T, one mma chain each per warp (K and V are
//     n-major B operands by plain ldmatrix); P and dS = P (dP - delta)
//     scale are formed in the f32 accumulator fragments, and dS goes from
//     those registers straight to the bf16 A operand of dS K (K's k-major
//     B fragments by ldmatrix.trans of the same tile), as the forward
//     feeds P to P V: dS never touches shared memory;
//   * dq stays in f32 registers (64 a thread at d = 128) for the whole
//     key loop and is written once as bf16;
//   * precision: dS enters dS K in two bf16 parts, hi + lo, as dk/dv's
//     dS^T does (see there; tests/test_torch_flash_precision.py emulates
//     both kernels' roundings on the CPU against the JAX package);
//   * key tiles wholly above the causal diagonal are never loaded, and a
//     warp skips the tiles above the diagonal of all its 16 rows (exact:
//     p = 0 there).
//
// dq and dk/dv in f32 -- the first versions, products on the CUDA cores
// in f32 (f32 inputs keep them: their 1e-5 tolerance is beyond a TF32 or
// bf16 tensor core):
//   * dq: one CTA per (batch, query head, 64 query rows), 256 threads, four
//     per row; 32-key K/V tiles stream through shared memory, only the tiles
//     the causal mask leaves live are loaded;
//   * dk/dv: one CTA per (batch, KV head, 64 keys) over the group's query
//     heads and the 32-row query tiles that can see its keys;
//   * shared rows are padded by four floats so every float4 read is
//     conflict-free; p and ds of a tile go through shared memory between
//     the score pass and the accumulate pass, read back only by the four
//     lanes of the row that wrote them.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 256;         // threads per CTA: 64 rows x 4 lanes
constexpr int DQ_BQ = 64;       // dq: query rows per CTA
constexpr int DQ_BK = 32;       // dq: keys per tile
constexpr int KV_BK = 64;       // dk/dv: keys per CTA
constexpr int KV_BQ = 32;       // dk/dv: query rows per tile

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * DQ_BQ * (D + 4) + 2 * DQ_BK * (D + 4) +
                          DQ_BQ * (DQ_BK + 1)) +
         sizeof(int) * DQ_BK;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * KV_BK * (D + 4) + 2 * KV_BQ * (D + 4) +
                          2 * KV_BK * (KV_BQ + 1) + 2 * KV_BQ) +
         sizeof(int) * KV_BQ;
}

// Rows [r0, r0 + rows) of a (n, D) matrix into a padded f32 tile; rows past
// n load as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int n, int rows,
                                          float* __restrict__ dst) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    if (r0 + r < n)
      hvd::load8(src + (size_t)(r0 + r) * D + c, dst + r * (D + 4) + c);
    else
      hvd::zero8(dst + r * (D + 4) + c);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// dq = sum over keys of ds K
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg, T* __restrict__ dq,
                        int h, int h_kv, int tq, int tk, int causal,
                        float scale) {
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  constexpr int SD = D + 4;      // padded row of every tile
  constexpr int NJ = BK / 4;     // scores per thread per tile
  constexpr int NG = D / 16;     // float4 groups of dq per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [BQ][SD]
  float* sDO = sQ + BQ * SD;     // [BQ][SD]
  float* sK = sDO + BQ * SD;     // [BK][SD]
  float* sV = sK + BK * SD;      // [BK][SD]
  float* sDS = sV + BK * SD;     // [BQ][BK + 1]
  int* sKseg = reinterpret_cast<int*>(sDS + BQ * (BK + 1));  // [BK]

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (h / h_kv);
  const int tid = threadIdx.x, row = tid >> 2, l4 = tid & 3;
  const int off = tk - tq;
  const size_t qbase = (size_t)(bb * h + hh) * tq;
  const size_t kbase = (size_t)(bb * h_kv + kvh) * tk;
  const bool has_seg = qseg != nullptr;

  load_tile<T, D>(q + qbase * D, q0, tq, BQ, sQ);
  load_tile<T, D>(dout + qbase * D, q0, tq, BQ, sDO);
  const int qrow = q0 + row;
  const bool row_ok = qrow < tq;
  const float my_lse = row_ok ? lse[qbase + qrow] : 0.f;
  const float my_delta = row_ok ? delta[qbase + qrow] : 0.f;
  const int my_seg = (has_seg && row_ok) ? qseg[bb * tq + qrow] : 0;

  float acc[NG * 4];
#pragma unroll
  for (int i = 0; i < NG * 4; ++i) acc[i] = 0.f;

  // Keys past the causal diagonal of this tile's last row never load.
  const int kv_end = causal ? min(tk, q0 + BQ + off) : tk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every reader of the previous tile is done
    load_tile<T, D>(k + kbase * D, k0, tk, BK, sK);
    load_tile<T, D>(v + kbase * D, k0, tk, BK, sV);
    if (has_seg && tid < BK)
      sKseg[tid] = (k0 + tid < tk) ? kseg[bb * tk + k0 + tid] : 0;
    __syncthreads();

    float s[NJ], dp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      const float4 qv = f4(sQ + row * SD + kk);
      const float4 ov = f4(sDO + row * SD + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j] = dot4(qv, f4(sK + (l4 + 4 * j) * SD + kk), s[j]);
        dp[j] = dot4(ov, f4(sV + (l4 + 4 * j) * SD + kk), dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int cl = l4 + 4 * j, col = k0 + cl;
      bool live = row_ok && col < tk;
      if (causal && col > qrow + off) live = false;
      if (has_seg && sKseg[cl] != my_seg) live = false;
      const float p = live ? expf(s[j] * scale - my_lse) : 0.f;
      sDS[row * (BK + 1) + cl] = p * (dp[j] - my_delta) * scale;
    }
    __syncwarp();  // a row's ds is written and read by its own 4 lanes

    for (int c = 0; c < BK; ++c) {
      const float ds = sDS[row * (BK + 1) + c];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kv = f4(sK + c * SD + 16 * g + 4 * l4);
        acc[4 * g + 0] = fmaf(ds, kv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(ds, kv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(ds, kv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(ds, kv.w, acc[4 * g + 3]);
      }
    }
  }

  if (!row_ok) return;
  T* out = dq + (qbase + qrow) * D;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[16 * g + 4 * l4 + e] = hvd::from_float<T>(acc[4 * g + e]);
}

// ---------------------------------------------------------------------------
// dv = sum over queries of p^T dO, dk = sum over queries of ds^T Q, summed
// over the rep query heads that share the KV head
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, T* __restrict__ dk,
                         T* __restrict__ dv, int h, int h_kv, int tq, int tk,
                         int causal, float scale) {
  constexpr int BK = KV_BK, BQ = KV_BQ;
  constexpr int SD = D + 4;
  constexpr int NJ = BQ / 4;     // queries per thread per tile
  constexpr int NG = D / 16;
  constexpr int SP = BQ + 1;     // padded row of sP / sDS
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;              // [BK][SD]
  float* sV = sK + BK * SD;      // [BK][SD]
  float* sQ = sV + BK * SD;      // [BQ][SD]
  float* sDO = sQ + BQ * SD;     // [BQ][SD]
  float* sP = sDO + BQ * SD;     // [BK][SP]
  float* sDS = sP + BK * SP;     // [BK][SP]
  float* sLse = sDS + BK * SP;   // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]
  int* sQseg = reinterpret_cast<int*>(sDelta + BQ);  // [BQ]

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, bb = blockIdx.z;
  const int rep = h / h_kv;
  const int tid = threadIdx.x, krow = tid >> 2, l4 = tid & 3;
  const int off = tk - tq;
  const size_t kbase = (size_t)(bb * h_kv + kvh) * tk;
  const bool has_seg = qseg != nullptr;

  load_tile<T, D>(k + kbase * D, k0, tk, BK, sK);
  load_tile<T, D>(v + kbase * D, k0, tk, BK, sV);
  const int kcol = k0 + krow;
  const bool key_ok = kcol < tk;
  const int my_seg = (has_seg && key_ok) ? kseg[bb * tk + kcol] : 0;

  float acc_k[NG * 4], acc_v[NG * 4];
#pragma unroll
  for (int i = 0; i < NG * 4; ++i) acc_k[i] = acc_v[i] = 0.f;

  // Query rows before k0 - off see none of these keys (causal).
  const int q_begin = causal ? max(0, k0 - off) / BQ * BQ : 0;
  for (int r = 0; r < rep; ++r) {
    const size_t qbase = (size_t)(bb * h + kvh * rep + r) * tq;
    for (int q0 = q_begin; q0 < tq; q0 += BQ) {
      __syncthreads();  // every reader of the previous tile is done
      load_tile<T, D>(q + qbase * D, q0, tq, BQ, sQ);
      load_tile<T, D>(dout + qbase * D, q0, tq, BQ, sDO);
      if (tid < BQ) {
        const bool ok = q0 + tid < tq;
        sLse[tid] = ok ? lse[qbase + q0 + tid] : 0.f;
        sDelta[tid] = ok ? delta[qbase + q0 + tid] : 0.f;
        if (has_seg) sQseg[tid] = ok ? qseg[bb * tq + q0 + tid] : 0;
      }
      __syncthreads();

      float s[NJ], dp[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 4) {
        const float4 kv = f4(sK + krow * SD + kk);
        const float4 vv = f4(sV + krow * SD + kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[j] = dot4(kv, f4(sQ + (l4 + 4 * j) * SD + kk), s[j]);
          dp[j] = dot4(vv, f4(sDO + (l4 + 4 * j) * SD + kk), dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ql = l4 + 4 * j, qi = q0 + ql;
        bool live = key_ok && qi < tq;
        if (causal && kcol > qi + off) live = false;
        if (has_seg && sQseg[ql] != my_seg) live = false;
        const float p = live ? expf(s[j] * scale - sLse[ql]) : 0.f;
        sP[krow * SP + ql] = p;
        sDS[krow * SP + ql] = p * (dp[j] - sDelta[ql]) * scale;
      }
      __syncwarp();  // a key's p / ds are written and read by its 4 lanes

      for (int c = 0; c < BQ; ++c) {
        const float p = sP[krow * SP + c];
        const float ds = sDS[krow * SP + c];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 ov = f4(sDO + c * SD + 16 * g + 4 * l4);
          const float4 qv = f4(sQ + c * SD + 16 * g + 4 * l4);
          acc_v[4 * g + 0] = fmaf(p, ov.x, acc_v[4 * g + 0]);
          acc_v[4 * g + 1] = fmaf(p, ov.y, acc_v[4 * g + 1]);
          acc_v[4 * g + 2] = fmaf(p, ov.z, acc_v[4 * g + 2]);
          acc_v[4 * g + 3] = fmaf(p, ov.w, acc_v[4 * g + 3]);
          acc_k[4 * g + 0] = fmaf(ds, qv.x, acc_k[4 * g + 0]);
          acc_k[4 * g + 1] = fmaf(ds, qv.y, acc_k[4 * g + 1]);
          acc_k[4 * g + 2] = fmaf(ds, qv.z, acc_k[4 * g + 2]);
          acc_k[4 * g + 3] = fmaf(ds, qv.w, acc_k[4 * g + 3]);
        }
      }
    }
  }

  if (!key_ok) return;
  T* dk_row = dk + (kbase + kcol) * D;
  T* dv_row = dv + (kbase + kcol) * D;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_row[16 * g + 4 * l4 + e] = hvd::from_float<T>(acc_k[4 * g + e]);
      dv_row[16 * g + 4 * l4 + e] = hvd::from_float<T>(acc_v[4 * g + e]);
    }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* qseg, const void* kseg, void* dq, int b,
                      int h, int h_kv, int tq, int tk, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;  // one opt-in per instantiation
  cudaError_t err = opt_in(flash_bwd_dq_kernel<T, D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + DQ_BQ - 1) / DQ_BQ, h, b);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<T*>(dq), h, h_kv, tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* qseg, const void* kseg, void* dk, void* dv,
                       int b, int h, int h_kv, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<T, D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((tk + KV_BK - 1) / KV_BK, h_kv, b);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<T*>(dk), static_cast<T*>(dv), h, h_kv, tq, tk, causal,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dk/dv in bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;     // keys per CTA
constexpr int MMA_BQ = 64;     // query rows per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (2 * MMA_BK * D + 2 * 2 * MMA_BQ * D + 3 * MMA_BK * MMA_BQ) +
         sizeof(float) * 2 * 2 * MMA_BQ + sizeof(int) * 2 * MMA_BQ;
}

// Warp roles (8 warps, w = warp):
//  * S^T and dP^T (64 keys x 64 queries): keys 16 (w % 4) .. +16, queries
//    32 (w / 4) .. +32 -- four 16 x 8 accumulator tiles each;
//  * dK and dV (64 keys x D): the same 16 keys, columns (w / 4) D/2 .. +D/2
//    -- D/16 tiles each, held in f32 registers across the whole loop.
template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ qseg,
                             const int* __restrict__ kseg,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int b, int h,
                             int h_kv, int tq, int tk, int causal,
                             float scale) {
  using namespace hvd::mma;
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int NG = D / 16;            // dK / dV n-tiles per warp
  constexpr int TILE = MMA_BQ * D * 2;  // bytes of one Q or dO stage
  extern __shared__ __align__(128) unsigned char mma_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [BK][D]
  __nv_bfloat16* sV = sK + MMA_BK * D;                  // [BK][D]
  __nv_bfloat16* sQ = sV + MMA_BK * D;                  // [2][BQ][D]
  __nv_bfloat16* sDO = sQ + 2 * MMA_BQ * D;             // [2][BQ][D]
  __nv_bfloat16* sPt = sDO + 2 * MMA_BQ * D;            // [BK][BQ]
  __nv_bfloat16* sDSt = sPt + MMA_BK * MMA_BQ;          // [BK][BQ] hi
  __nv_bfloat16* sDStLo = sDSt + MMA_BK * MMA_BQ;       // [BK][BQ] lo
  float* sLse = reinterpret_cast<float*>(sDStLo + MMA_BK * MMA_BQ);  // [2][BQ]
  float* sDelta = sLse + 2 * MMA_BQ;                    // [2][BQ]
  int* sQseg = reinterpret_cast<int*>(sDelta + 2 * MMA_BQ);  // [2][BQ]

  // One flat grid with the key block slowest: key block 0, which the most
  // query tiles see under the causal mask, is dispatched first.
  const int bkv = blockIdx.x % (b * h_kv);
  const int k0 = blockIdx.x / (b * h_kv) * MMA_BK;
  const int kvh = bkv % h_kv, bb = bkv / h_kv;
  const int rep = h / h_kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int off = tk - tq;
  const size_t kbase = (size_t)(bb * h_kv + kvh) * tk;
  const bool has_seg = qseg != nullptr;
  const uint32_t aK = smem_addr(sK), aV = smem_addr(sV);
  const uint32_t aQ = smem_addr(sQ), aDO = smem_addr(sDO);
  const uint32_t aPt = smem_addr(sPt), aDSt = smem_addr(sDSt);
  const uint32_t aDStLo = smem_addr(sDStLo);
  const uint32_t aLse = smem_addr(sLse), aDelta = smem_addr(sDelta);
  const uint32_t aSeg = smem_addr(sQseg);

  for (int i = tid; i < MMA_BK * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = k0 + r < tk;
    const size_t row = (kbase + (ok ? k0 + r : 0)) * D + c * 8;
    cp_async16(aK + swizzle<D>(r, c), k + row, ok);
    cp_async16(aV + swizzle<D>(r, c), v + row, ok);
  }

  // Query rows before k0 - off see none of these keys (causal).
  const int q_begin = causal ? max(0, k0 - off) / MMA_BQ * MMA_BQ : 0;
  const int n_qt = (tq - q_begin + MMA_BQ - 1) / MMA_BQ;
  const int n_it = rep * n_qt;
  // Q, dO, lse, delta and segment ids of iteration `it` (query head
  // kvh * rep + it / n_qt, rows from q_begin + (it % n_qt) * BQ) into ring
  // stage st; rows past tq are zero-filled.
  auto load_q = [&](int it, int st) {
    const size_t qbase = (size_t)(bb * h + kvh * rep + it / n_qt) * tq;
    const int q0 = q_begin + (it % n_qt) * MMA_BQ;
    for (int i = tid; i < MMA_BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = q0 + r < tq;
      const size_t row = (qbase + (ok ? q0 + r : 0)) * D + c * 8;
      cp_async16(aQ + st * TILE + swizzle<D>(r, c), q + row, ok);
      cp_async16(aDO + st * TILE + swizzle<D>(r, c), dout + row, ok);
    }
    if (tid < MMA_BQ) {
      const bool ok = q0 + tid < tq;
      const size_t row = qbase + (ok ? q0 + tid : 0);
      const uint32_t so = 4 * (st * MMA_BQ + tid);
      cp_async4(aLse + so, lse + row, ok);
      cp_async4(aDelta + so, delta + row, ok);
      if (has_seg)
        cp_async4(aSeg + so, qseg + (size_t)bb * tq + (ok ? q0 + tid : 0),
                  ok);
    }
  };
  load_q(0, 0);
  cp_async_commit();

  const int kw = (warp & 3) * 16;          // this warp's first key
  const int qw = (warp >> 2) * 32;         // its first query (S^T, dP^T)
  const int dw = (warp >> 2) * (D / 2);    // its first column (dK, dV)
  const int keys[2] = {k0 + kw + g, k0 + kw + g + 8};
  int my_seg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (keys[i] < tk) my_seg[i] = kseg[(size_t)bb * tk + keys[i]];
  }
  float acc_k[NG][4], acc_v[NG][4];
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; everyone is done with it - 1
    if (it + 1 < n_it) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int st = it & 1;
    const int q0 = q_begin + (it % n_qt) * MMA_BQ;
    const uint32_t sq = aQ + st * TILE, sdo = aDO + st * TILE;

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bf[4];
      ldmatrix_x4(a, a_frag_addr<D>(aK, kw, kk, lane));
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        ldmatrix_x4(bf, b_frag_addr<D>(sq, qw + nn * 16, kk, lane));
        mma_bf16(s[2 * nn], a, bf[0], bf[1]);
        mma_bf16(s[2 * nn + 1], a, bf[2], bf[3]);
      }
      ldmatrix_x4(a, a_frag_addr<D>(aV, kw, kk, lane));
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        ldmatrix_x4(bf, b_frag_addr<D>(sdo, qw + nn * 16, kk, lane));
        mma_bf16(dp[2 * nn], a, bf[0], bf[1]);
        mma_bf16(dp[2 * nn + 1], a, bf[2], bf[3]);
      }
    }

    // P^T = exp(S^T scale - lse) on live pairs (0 elsewhere, and on dead
    // rows, whose lse is +1e30); dS^T = P^T (dP^T - delta) scale.  Both
    // to shared memory as bf16 pairs, dS^T as hi and lo parts.
    const float* lse_t = sLse + st * MMA_BQ;
    const float* delta_t = sDelta + st * MMA_BQ;
    const int* seg_t = sQseg + st * MMA_BQ;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = qw + 8 * n + c2 + (e & 1), qi = q0 + ql;
        const int key = keys[e >> 1];
        bool live = key < tk && qi < tq;
        if (causal && key > qi + off) live = false;
        if (has_seg && seg_t[ql] != my_seg[e >> 1]) live = false;
        p[e] = live ? exp2f(s[n][e] * sl2 - lse_t[ql] * kLog2e) : 0.f;
        ds[e] = p[e] * (dp[n][e] - delta_t[ql]) * scale;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t at = swizzle<MMA_BQ>(kw + g + 8 * i, (qw >> 3) + n) +
                            2 * c2;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(sPt) +
                                     at) = pack_bf16(p[2 * i], p[2 * i + 1]);
        const uint32_t hi = pack_bf16(ds[2 * i], ds[2 * i + 1]);
        const float2 r = unpack_bf16(hi);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(sDSt) +
                                     at) = hi;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(sDStLo) +
                                     at) =
            pack_bf16(ds[2 * i] - r.x, ds[2 * i + 1] - r.y);
      }
    }
    __syncthreads();  // P^T and dS^T complete

    // dV += P^T dO and dK += dS^T Q (hi, then lo) over the tile's 64
    // queries.
#pragma unroll
    for (int kk = 0; kk < MMA_BQ / 16; ++kk) {
      uint32_t ap[4], ads[4], alo[4];
      ldmatrix_x4(ap, a_frag_addr<MMA_BQ>(aPt, kw, kk, lane));
      ldmatrix_x4(ads, a_frag_addr<MMA_BQ>(aDSt, kw, kk, lane));
      ldmatrix_x4(alo, a_frag_addr<MMA_BQ>(aDStLo, kw, kk, lane));
#pragma unroll
      for (int nn = 0; nn < NG / 2; ++nn) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, a_frag_addr<D>(sdo, kk * 16, (dw >> 4) + nn, lane));
        mma_bf16(acc_v[2 * nn], ap, bf[0], bf[1]);
        mma_bf16(acc_v[2 * nn + 1], ap, bf[2], bf[3]);
        ldmatrix_x4_trans(
            bf, a_frag_addr<D>(sq, kk * 16, (dw >> 4) + nn, lane));
        mma_bf16(acc_k[2 * nn], ads, bf[0], bf[1]);
        mma_bf16(acc_k[2 * nn + 1], ads, bf[2], bf[3]);
        mma_bf16(acc_k[2 * nn], alo, bf[0], bf[1]);
        mma_bf16(acc_k[2 * nn + 1], alo, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();  // nothing may be left in flight at exit

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= tk) continue;
    __nv_bfloat16* dk_row = dk + (kbase + keys[i]) * D + dw;
    __nv_bfloat16* dv_row = dv + (kbase + keys[i]) * D + dw;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      *reinterpret_cast<uint32_t*>(dk_row + 8 * n + c2) =
          pack_bf16(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv_row + 8 * n + c2) =
          pack_bf16(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* qseg,
                           const void* kseg, void* dk, void* dv, int b, int h,
                           int h_kv, int tq, int tk, int causal, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = opt_in(flash_bwd_dkv_mma_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int n_k = (tk + MMA_BK - 1) / MMA_BK;
  flash_bwd_dkv_mma_kernel<D><<<n_k * b * h_kv, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), b, h,
      h_kv, tq, tk, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dq in bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int DQM_BQ = 128;    // query rows per CTA: 8 warps x 16
constexpr int DQM_BK = 64;     // keys per K/V tile

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * DQM_BQ * D + 2 * 2 * DQM_BK * D) +
         sizeof(int) * 2 * DQM_BK;
}

// Warp w owns query rows 16 w .. +16 of the tile: S and dP (16 x 64 keys,
// eight 16 x 8 accumulator tiles each), then dS packed to bf16 A fragments
// in registers, and dq (16 x D) in f32 registers across the whole key loop.
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ qseg,
                            const int* __restrict__ kseg,
                            __nv_bfloat16* __restrict__ dq, int b, int h,
                            int h_kv, int tq, int tk, int causal,
                            float scale) {
  using namespace hvd::mma;
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int NS = DQM_BK / 8;     // S / dP n-tiles per warp
  constexpr int NO = D / 8;          // dq n-tiles per warp
  constexpr uint32_t STAGE = DQM_BK * D * 2;  // bytes of one K or V stage
  extern __shared__ __align__(128) unsigned char mma_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [BQ][D]
  __nv_bfloat16* sDO = sQ + DQM_BQ * D;                 // [BQ][D]
  __nv_bfloat16* sK = sDO + DQM_BQ * D;                 // [2][BK][D]
  __nv_bfloat16* sV = sK + 2 * DQM_BK * D;              // [2][BK][D]
  int* sKseg = reinterpret_cast<int*>(sV + 2 * DQM_BK * D);  // [2][BK]

  // One flat grid, the query tile slowest and reversed: the last tiles
  // (the most keys under the causal mask) are dispatched first.
  const int bh = blockIdx.x % (b * h);
  const int q0 = (gridDim.x / (b * h) - 1 - blockIdx.x / (b * h)) * DQM_BQ;
  const int hh = bh % h, bb = bh / h;
  const int kvh = hh / (h / h_kv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int off = tk - tq;
  const size_t qbase = (size_t)(bb * h + hh) * tq;
  const __nv_bfloat16* kb = k + (size_t)(bb * h_kv + kvh) * tk * D;
  const __nv_bfloat16* vb = v + (size_t)(bb * h_kv + kvh) * tk * D;
  const bool has_seg = qseg != nullptr;
  const uint32_t aQ = smem_addr(sQ), aDO = smem_addr(sDO);
  const uint32_t aK = smem_addr(sK), aV = smem_addr(sV);
  const uint32_t aSeg = smem_addr(sKseg);

  for (int i = tid; i < DQM_BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < tq;
    const size_t row = (qbase + (ok ? q0 + r : 0)) * D + c * 8;
    cp_async16(aQ + swizzle<D>(r, c), q + row, ok);
    cp_async16(aDO + swizzle<D>(r, c), dout + row, ok);
  }
  // K/V tile of keys [k0, k0 + BK) into ring stage st; keys past tk are
  // zero-filled.
  auto load_kv = [&](int k0, int st) {
    for (int i = tid; i < DQM_BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < tk;
      const size_t row = (size_t)(ok ? k0 + r : 0) * D + c * 8;
      cp_async16(aK + st * STAGE + swizzle<D>(r, c), kb + row, ok);
      cp_async16(aV + st * STAGE + swizzle<D>(r, c), vb + row, ok);
    }
    if (has_seg && tid < DQM_BK) {
      const bool ok = k0 + tid < tk;
      cp_async4(aSeg + 4 * (st * DQM_BK + tid),
                kseg + (size_t)bb * tk + (ok ? k0 + tid : 0), ok);
    }
  };

  // Keys past the causal diagonal of this tile's last row never load.
  const int kv_end = causal ? min(tk, q0 + DQM_BQ + off) : tk;
  const int n_tiles = (kv_end + DQM_BK - 1) / DQM_BK;
  load_kv(0, 0);
  cp_async_commit();

  const int w0 = q0 + warp * 16;             // first row of this warp
  const int rows[2] = {w0 + g, w0 + g + 8};  // this thread's two rows
  float lse2[2], dlt[2];                     // lse in log2 units, delta
  int my_seg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = rows[i] < tq;
    lse2[i] = ok ? lse[qbase + rows[i]] * kLog2e : 0.f;
    dlt[i] = ok ? delta[qbase + rows[i]] : 0.f;
    if (has_seg && ok) my_seg[i] = qseg[(size_t)bb * tq + rows[i]];
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; stage it^1 is free again
    if (it + 1 < n_tiles) load_kv((it + 1) * DQM_BK, (it + 1) & 1);
    cp_async_commit();
    const int st = it & 1;
    const uint32_t sk = aK + st * STAGE, sv = aV + st * STAGE;
    const int* seg_t = sKseg + st * DQM_BK;
    const int k0 = it * DQM_BK;
    // Every key of this tile lies above the diagonal of all 16 rows: p = 0
    // there, nothing to add.
    if (causal && k0 > w0 + 15 + off) continue;

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldmatrix_x4(aq, a_frag_addr<D>(aQ, warp * 16, kk, lane));
      ldmatrix_x4(ado, a_frag_addr<D>(aDO, warp * 16, kk, lane));
#pragma unroll
      for (int nn = 0; nn < NS / 2; ++nn) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b_frag_addr<D>(sk, nn * 16, kk, lane));
        mma_bf16(s[2 * nn], aq, bf[0], bf[1]);
        mma_bf16(s[2 * nn + 1], aq, bf[2], bf[3]);
        ldmatrix_x4(bf, b_frag_addr<D>(sv, nn * 16, kk, lane));
        mma_bf16(dp[2 * nn], ado, bf[0], bf[1]);
        mma_bf16(dp[2 * nn + 1], ado, bf[2], bf[3]);
      }
    }

    // P = exp(S scale - lse) on live pairs (0 elsewhere, and on dead rows,
    // whose lse is +1e30), then dS = P (dP - delta) scale, in place of S.
    // Only tiles at the ragged end, on the causal diagonal or with segment
    // ids need the per-element mask; rows past tq have zero Q and dO, so
    // their dS is 0 and they are never stored.
    const bool masked = has_seg || k0 + DQM_BK > tk ||
                        (causal && k0 + DQM_BK - 1 > w0 + off);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(s[n][e] * sl2 - lse2[i]);
        if (masked) {
          const int cl = 8 * n + c2 + (e & 1), col = k0 + cl;
          bool live = col < tk;
          if (causal && col > rows[i] + off) live = false;
          if (has_seg && seg_t[cl] != my_seg[i]) live = false;
          if (!live) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - dlt[i]) * scale;
      }

    // dq += dS K: dS from the C fragments straight to bf16 A fragments
    // in two parts, hi = bf16(dS) and lo = bf16(dS - hi), both multiplied
    // by K's k-major B fragments (ldmatrix.trans of the same swizzled
    // tile).
#pragma unroll
    for (int kk = 0; kk < DQM_BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {   // rows g, g + 8
          const float d0 = s[2 * kk + half][2 * i];
          const float d1 = s[2 * kk + half][2 * i + 1];
          hi[2 * half + i] = pack_bf16(d0, d1);
          const float2 r = unpack_bf16(hi[2 * half + i]);
          lo[2 * half + i] = pack_bf16(d0 - r.x, d1 - r.y);
        }
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, a_frag_addr<D>(sk, kk * 16, nn, lane));
        mma_bf16(acc[2 * nn], hi, bf[0], bf[1]);
        mma_bf16(acc[2 * nn + 1], hi, bf[2], bf[3]);
        mma_bf16(acc[2 * nn], lo, bf[0], bf[1]);
        mma_bf16(acc[2 * nn + 1], lo, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();  // nothing may be left in flight at exit

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= tq) continue;
    __nv_bfloat16* out = dq + (qbase + rows[i]) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n + c2) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* qseg,
                          const void* kseg, void* dq, int b, int h, int h_kv,
                          int tq, int tk, int causal, float scale,
                          cudaStream_t stream) {
  constexpr size_t smem = dq_mma_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = opt_in(flash_bwd_dq_mma_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int n_q = (tq + DQM_BQ - 1) / DQM_BQ;
  flash_bwd_dq_mma_kernel<D><<<n_q * b * h, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<__nv_bfloat16*>(dq), b, h, h_kv, tq, tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* qseg,
                                const void* kseg, void* dq, int b, int h,
                                int h_kv, int tq, int tk, int d, int dtype,
                                int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hvd::kBF16 && d == 128)
    return launch_dq_mma<128>(q, k, v, dout, lse, delta, qseg, kseg, dq, b,
                              h, h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kBF16 && d == 64)
    return launch_dq_mma<64>(q, k, v, dout, lse, delta, qseg, kseg, dq, b, h,
                             h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, qseg, kseg, dq,
                                 b, h, h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, qseg, kseg, dq, b,
                                h, h_kv, tq, tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* qseg,
                                 const void* kseg, void* dk, void* dv, int b,
                                 int h, int h_kv, int tq, int tk, int d,
                                 int dtype, int causal, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hvd::kBF16 && d == 128)
    return launch_dkv_mma<128>(q, k, v, dout, lse, delta, qseg, kseg, dk, dv,
                               b, h, h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kBF16 && d == 64)
    return launch_dkv_mma<64>(q, k, v, dout, lse, delta, qseg, kseg, dk, dv,
                              b, h, h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, qseg, kseg, dk,
                                  dv, b, h, h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, qseg, kseg, dk,
                                 dv, b, h, h_kv, tq, tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
