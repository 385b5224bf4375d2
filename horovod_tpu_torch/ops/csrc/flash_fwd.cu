// FlashAttention-2 forward for Hopper (sm_90a): O and the logsumexp.
//
// Replaces: horovod_tpu/ops/attention.py::_flash_fwd (kernel body
// _fwd_kernel), the Pallas TPU kernel that prefill and every transformer
// layer call.  Same function: online softmax over key tiles, causal mask
// aligned bottom-right (query i sits at absolute position tk - tq + i),
// grouped-query attention by reading kv head h / rep (K/V are never
// repeated in memory), optional segment ids (a query sees only keys of an
// equal id; a row that sees no key is DEAD and gives O = 0, lse = +1e30),
// masked logits at the finite -1e30, keys past tk at -inf.  Every sum
// accumulates in f32.
//
// What bounds it on the H100: at the prefill shapes (b=1, h=32, t=2048,
// d=128, causal) the work is ~34 GFLOP against ~42 MB of q/k/v/o, i.e.
// ~800 FLOP per byte -- far above the card's ~295 FLOP/byte balance point,
// so the bound is arithmetic (35 us at the 989 TFLOP/s bf16 tensor-core
// peak).  Two bodies, chosen by dtype in hvd_flash_fwd:
//
// bf16 -- flash_fwd_mma_kernel, both products on the tensor cores
// (mma.sync m16n8k16, f32 accumulators; mma.cuh):
//   * one CTA per (batch, query head, 128 query rows), 8 warps of 16 rows;
//     CTAs of the last query tiles (the most causal work) launch first;
//   * Q is loaded once into shared memory; K and V stream as 64-key bf16
//     tiles through a 2-stage cp.async ring (the next tile loads while
//     this one is used), in an XOR-swizzled layout so that cp.async and
//     ldmatrix are free of bank conflicts: 96 KB at d = 128;
//   * S = Q K^T lands in f32 accumulator fragments (32 a thread), where
//     the masks and the online softmax run; a row's max and sum take two
//     quad shuffles.  P goes from those registers straight to the A
//     operand of P V (V's B fragments by ldmatrix.trans): P never touches
//     shared memory.  O stays in f32 registers (64 a thread at d = 128);
//   * precision: P enters P V as two bf16 parts, hi = bf16(P) and
//     lo = bf16(P - hi), two products on the same V fragments, so P keeps
//     ~16 bits; the row sums use the f32 P.  One bf16 rounding of P (the
//     textbook FlashAttention-2) is 2x cheaper in P V but moved the LoRA
//     gradients of chip_smoke.py's 2-layer Llama-3 8B check from 1.3 % to
//     2.3 % of their max against the f32 reference, past its 2 % bound;
//     hi + lo keeps them at 1.4 %.  That costs the third product;
//   * registers: O, S and P's parts take ~110 of a thread's registers;
//     the kernel is built for one CTA an SM (up to 255 registers; ~220
//     used at d = 128).  At two CTAs an SM (128 registers) it spills, and
//     Q's A fragments, re-read from shared memory for every key tile,
//     would not fit in registers either;
//   * key tiles wholly above the causal diagonal are never loaded, and a
//     warp skips the products of a tile above the diagonal of all its 16
//     rows (exact: such keys add exp(-1e30 - m) = 0 to a row that has
//     seen key 0, and a dead row's output is forced to zero anyway).
//
// f32 -- flash_fwd_kernel, the first version, kept for f32 inputs (whose
// 1e-5 tolerance a TF32 or bf16 tensor core cannot meet): products on the
// CUDA cores in f32; one CTA per (batch, query head, 64-row query tile),
// 256 threads, four per query row; 32-key K/V tiles through padded f32
// shared rows, every float4 read feeding 4-8 FMAs from registers.
//
// The bf16 body can also write O's rounding residual, o_lo =
// bf16(O - bf16(O)) (hvd_flash_fwd's o_lo, NULL to skip it): the backward
// forms delta = rowsum(dO * O) from hi + lo.  delta from the bf16 O
// alone is off by ~2^-9, and dS = P (dP - delta) then no longer sums to
// zero over a query's keys, so a component every key shares (BERT's
// second layer, chip_smoke.py bert_grad) leaks into dq and into the key
// weights' gradient; the plain attention's autograd has the f32 O.
//
// Both mask the ragged edge in the kernel (any tk, any tq -- e.g. a
// 37-token prompt): keys past tk count as -inf, rows past tq are not
// stored.  There is no fallback to a plain path for any length.  Blocks
// carry nothing between them: the launch needs no scratch and allocates
// nothing.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 32;         // keys per tile
constexpr int NT = 256;        // threads: BQ rows x 4 lanes
constexpr float kNeg = -1e30f; // finite mask value, as the reference

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 4) + BK * (D + 4) + BK * D +
                          BQ * (BK + 1)) +
         sizeof(int) * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, T* __restrict__ o,
                     float* __restrict__ lse, int h, int h_kv, int tq,
                     int tk, int causal, float scale) {
  constexpr int SD = D + 4;      // padded row of sQ / sK
  constexpr int NJ = BK / 4;     // scores per thread per tile
  constexpr int NG = D / 16;     // float4 output groups per thread
  constexpr int CH = D / 8;      // 8-element chunks per row
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [BQ][SD]
  float* sK = sQ + BQ * SD;      // [BK][SD]
  float* sV = sK + BK * SD;      // [BK][D]
  float* sP = sV + BK * D;       // [BQ][BK + 1]
  int* sKseg = reinterpret_cast<int*>(sP + BQ * (BK + 1));  // [BK]

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (h / h_kv);
  const int tid = threadIdx.x, row = tid >> 2, l4 = tid & 3;
  const int off = tk - tq;
  const T* qb = q + (size_t)(bb * h + hh) * tq * D;
  const T* kb = k + (size_t)(bb * h_kv + kvh) * tk * D;
  const T* vb = v + (size_t)(bb * h_kv + kvh) * tk * D;
  const bool has_seg = qseg != nullptr;

  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    if (q0 + r < tq)
      hvd::load8(qb + (size_t)(q0 + r) * D + c, sQ + r * SD + c);
    else
      hvd::zero8(sQ + r * SD + c);
  }
  const int qrow = q0 + row;
  const int my_seg = (has_seg && qrow < tq) ? qseg[bb * tq + qrow] : 0;

  float acc[NG * 4];
#pragma unroll
  for (int i = 0; i < NG * 4; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  // Keys past the causal diagonal of this tile's last row never load.
  const int kv_end = causal ? min(tk, q0 + BQ + off) : tk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every reader of the previous tile is done
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      if (k0 + r < tk) {
        hvd::load8(kb + (size_t)(k0 + r) * D + c, sK + r * SD + c);
        hvd::load8(vb + (size_t)(k0 + r) * D + c, sV + r * D + c);
      } else {
        hvd::zero8(sK + r * SD + c);
        hvd::zero8(sV + r * D + c);
      }
    }
    if (has_seg && tid < BK)
      sKseg[tid] = (k0 + tid < tk) ? kseg[bb * tk + k0 + tid] : 0;
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + row * SD + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sK + (l4 + 4 * j) * SD + kk);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int cl = l4 + 4 * j, col = k0 + cl;
      float x = s[j] * scale;
      if (col >= tk) {
        x = -INFINITY;  // ragged edge: not a key at all
      } else {
        if (causal && col > qrow + off) x = kNeg;
        if (has_seg && sKseg[cl] != my_seg) x = kNeg;
      }
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(s[j] - m_new);
      sP[row * (BK + 1) + l4 + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by its own 4 lanes

#pragma unroll
    for (int i = 0; i < NG * 4; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = sP[row * (BK + 1) + c];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(sV + c * D + 16 * g + 4 * l4);
        acc[4 * g + 0] = fmaf(p, vv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
      }
    }
  }

  if (qrow >= tq) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  // Dead row (segment ids only): no key ever rose above the mask floor.
  const bool dead = has_seg && (m <= kNeg * 0.5f);
  T* ob = o + ((size_t)(bb * h + hh) * tq + qrow) * D;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ob[16 * g + 4 * l4 + e] =
          hvd::from_float<T>(dead ? 0.f : acc[4 * g + e] / l_safe);
  if (l4 == 0)
    lse[(size_t)(bb * h + hh) * tq + qrow] =
        dead ? 1e30f : m + logf(l_safe);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 128;    // query rows per CTA: 8 warps x 16
constexpr int MMA_BK = 64;     // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (MMA_BQ * D + 2 * 2 * MMA_BK * D) +
         sizeof(int) * 2 * MMA_BK;
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ o_lo, int b, int h,
                         int h_kv, int tq, int tk, int causal, float scale) {
  using namespace hvd::mma;
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int NS = MMA_BK / 8;   // S n-tiles per warp (keys / 8)
  constexpr int NO = D / 8;        // O n-tiles per warp
  extern __shared__ __align__(128) unsigned char mma_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [BQ][D]
  __nv_bfloat16* sK = sQ + MMA_BQ * D;                 // [2][BK][D]
  __nv_bfloat16* sV = sK + 2 * MMA_BK * D;             // [2][BK][D]
  int* sKseg = reinterpret_cast<int*>(sV + 2 * MMA_BK * D);  // [2][BK]

  // One flat grid, the query tile slowest and reversed: the last tiles
  // (the most keys under the causal mask) are dispatched first.
  const int bh = blockIdx.x % (b * h);
  const int q0 = (gridDim.x / (b * h) - 1 - blockIdx.x / (b * h)) * MMA_BQ;
  const int hh = bh % h, bb = bh / h;
  const int kvh = hh / (h / h_kv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int off = tk - tq;
  const __nv_bfloat16* qb = q + (size_t)(bb * h + hh) * tq * D;
  const __nv_bfloat16* kb = k + (size_t)(bb * h_kv + kvh) * tk * D;
  const __nv_bfloat16* vb = v + (size_t)(bb * h_kv + kvh) * tk * D;
  const bool has_seg = qseg != nullptr;
  const uint32_t aQ = smem_addr(sQ), aK = smem_addr(sK), aV = smem_addr(sV);
  const uint32_t aSeg = smem_addr(sKseg);

  for (int i = tid; i < MMA_BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < tq;
    cp_async16(aQ + swizzle<D>(r, c),
               qb + (size_t)(ok ? q0 + r : 0) * D + c * 8, ok);
  }
  // K/V tile of keys [k0, k0 + BK) into ring stage st; keys past tk are
  // zero-filled.
  auto load_kv = [&](int k0, int st) {
    const uint32_t so = (uint32_t)(st * MMA_BK * D * 2);
    for (int i = tid; i < MMA_BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < tk;
      const size_t row = (size_t)(ok ? k0 + r : 0) * D + c * 8;
      cp_async16(aK + so + swizzle<D>(r, c), kb + row, ok);
      cp_async16(aV + so + swizzle<D>(r, c), vb + row, ok);
    }
    if (has_seg && tid < MMA_BK) {
      const bool ok = k0 + tid < tk;
      cp_async4(aSeg + 4 * (st * MMA_BK + tid),
                kseg + (size_t)bb * tk + (ok ? k0 + tid : 0), ok);
    }
  };

  // Keys past the causal diagonal of this tile's last row never load.
  const int kv_end = causal ? min(tk, q0 + MMA_BQ + off) : tk;
  const int n_tiles = (kv_end + MMA_BK - 1) / MMA_BK;
  load_kv(0, 0);
  cp_async_commit();

  const int w0 = q0 + warp * 16;           // first row of this warp
  const int rows[2] = {w0 + g, w0 + g + 8};  // this thread's two rows
  int my_seg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < tq) my_seg[i] = qseg[(size_t)bb * tq + rows[i]];
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's part

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; stage it^1 is free again
    if (it + 1 < n_tiles) load_kv((it + 1) * MMA_BK, (it + 1) & 1);
    cp_async_commit();
    const int st = it & 1;
    const uint32_t sk = aK + (uint32_t)(st * MMA_BK * D * 2);
    const uint32_t sv = aV + (uint32_t)(st * MMA_BK * D * 2);
    const int* seg_t = sKseg + st * MMA_BK;
    const int k0 = it * MMA_BK;
    // Every key of this tile lies above the diagonal of all 16 rows:
    // nothing to add (see the header).
    if (causal && k0 > w0 + 15 + off) continue;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_frag_addr<D>(aQ, warp * 16, kk, lane));
#pragma unroll
      for (int nn = 0; nn < NS / 2; ++nn) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b_frag_addr<D>(sk, nn * 16, kk, lane));
        mma_bf16(s[2 * nn], a, bf[0], bf[1]);
        mma_bf16(s[2 * nn + 1], a, bf[2], bf[3]);
      }
    }

    // Scale, mask, row max.  Only tiles at the ragged end, on the causal
    // diagonal or with segment ids need the per-element mask.
    const bool masked = has_seg || k0 + MMA_BK > tk ||
                        (causal && k0 + MMA_BK - 1 > w0 + off);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int cl = 8 * n + c2 + (e & 1), col = k0 + cl;
          if (col >= tk) {
            x = -INFINITY;  // ragged edge: not a key at all
          } else {
            if (causal && col > rows[e >> 1] + off) x = kNeg;
            if (has_seg && seg_t[cl] != my_seg[e >> 1]) x = kNeg;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // P = exp(x - m) in f32 (the row sums), then as the A operand of
    // P V in two bf16 parts, P = hi + lo: hi is P rounded to bf16 and lo
    // the rounding error, rounded again.  The two products share V's
    // fragments and carry P to ~16 bits (see the header).
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sn = s[2 * kk + half];
#pragma unroll
        for (int i = 0; i < 2; ++i) {   // rows g, g + 8
          const float p0 = exp2f((sn[2 * i] - m[i]) * kLog2e);
          const float p1 = exp2f((sn[2 * i + 1] - m[i]) * kLog2e);
          l[i] += p0 + p1;
          hi[2 * half + i] = pack_bf16(p0, p1);
          const float2 r = unpack_bf16(hi[2 * half + i]);
          lo[2 * half + i] = pack_bf16(p0 - r.x, p1 - r.y);
        }
      }
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, a_frag_addr<D>(sv, kk * 16, nn, lane));
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
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= tq) continue;
    const float l_safe = (l[i] == 0.f) ? 1.f : l[i];
    // Dead row (segment ids only): no key ever rose above the mask floor.
    const bool dead = has_seg && (m[i] <= kNeg * 0.5f);
    const float inv = dead ? 0.f : 1.f / l_safe;
    const size_t row = ((size_t)(bb * h + hh) * tq + rows[i]) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float o0 = acc[n][2 * i] * inv, o1 = acc[n][2 * i + 1] * inv;
      const uint32_t hi = pack_bf16(o0, o1);
      *reinterpret_cast<uint32_t*>(o + row + 8 * n + c2) = hi;
      if (o_lo != nullptr) {
        const float2 r = unpack_bf16(hi);
        *reinterpret_cast<uint32_t*>(o_lo + row + 8 * n + c2) =
            pack_bf16(o0 - r.x, o1 - r.y);
      }
    }
    if (c2 == 0)
      lse[(size_t)(bb * h + hh) * tq + rows[i]] =
          dead ? 1e30f : m[i] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* qseg, const void* kseg, void* o, void* lse,
                       void* o_lo, int b, int h, int h_kv, int tq, int tk,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_q = (tq + MMA_BQ - 1) / MMA_BQ;
  flash_fwd_mma_kernel<D><<<n_q * b * h, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<__nv_bfloat16*>(o_lo), b, h,
      h_kv, tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qseg, const void* kseg, void* o, void* lse,
                   int b, int h, int h_kv, int tq, int tk, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((tq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<T*>(o),
      static_cast<float*>(lse), h, h_kv, tq, tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// o_lo: bf16 only (an f32 O has no rounding to carry); NULL skips it.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             const void* qseg, const void* kseg, void* o,
                             void* lse, void* o_lo, int b, int h, int h_kv,
                             int tq, int tk, int d, int dtype, int causal,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o_lo != nullptr && dtype != hvd::kBF16)
    return (int)cudaErrorInvalidValue;
  if (dtype == hvd::kBF16 && d == 128)
    return launch_mma<128>(q, k, v, qseg, kseg, o, lse, o_lo, b, h, h_kv,
                           tq, tk, causal, scale, s);
  if (dtype == hvd::kBF16 && d == 64)
    return launch_mma<64>(q, k, v, qseg, kseg, o, lse, o_lo, b, h, h_kv,
                          tq, tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 128)
    return launch<float, 128>(q, k, v, qseg, kseg, o, lse, b, h, h_kv, tq,
                              tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 64)
    return launch<float, 64>(q, k, v, qseg, kseg, o, lse, b, h, h_kv, tq,
                             tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
