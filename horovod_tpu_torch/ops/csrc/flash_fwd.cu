// FlashAttention-2 forward for Hopper (sm_90a): O and the logsumexp.
//
// Replaces: horovod_tpu/ops/attention.py::_flash_fwd (kernel body
// _fwd_kernel), the Pallas TPU kernel that prefill and every transformer
// layer call.  Same function: online softmax over key tiles, causal mask
// aligned bottom-right (query i sits at absolute position tk - tq + i),
// grouped-query attention by reading kv head h / rep (K/V are never
// repeated in memory), optional segment ids (a query sees only keys of an
// equal id; a row that sees no key is DEAD and gives O = 0, lse = +1e30),
// masked logits at the finite -1e30.  Inputs are f32 or bf16; every sum
// accumulates in f32.
//
// What bounds it on the H100: at the prefill shapes (b=1, h=32, t=2048,
// d=128, causal) the work is ~34 GFLOP against ~42 MB of q/k/v/o, i.e.
// ~800 FLOP per byte -- far above the card's ~295 FLOP/byte balance point,
// so the bound is arithmetic (35 us at the 989 TFLOP/s bf16 tensor-core
// peak).  This first version is the simple one: it does its products on
// the CUDA cores in f32 (no mma.sync / wgmma / TMA yet), so it runs well
// above that bound; the tile shapes are chosen to keep it limited by FMA
// issue rather than by shared memory:
//   * one CTA per (batch, query head, 64-row query tile); 256 threads,
//     four per query row, so row statistics reduce with two shuffles;
//   * 32-key K/V tiles stream through shared memory, converted to f32
//     once on load with 16-byte vector reads; Q stays resident;
//   * shared rows are padded so every float4 read is conflict-free, and
//     each float4 of Q (or of V) feeds 8 (or 4) FMAs from registers;
//   * running max, normalizer and the 32 output accumulators per thread
//     live in registers; nothing carries between CTAs (the TPU grid's
//     sequential kv axis becomes the in-CTA loop);
//   * key tiles wholly above the causal diagonal are never loaded, and
//     the ragged edge (any tk, any tq -- e.g. a 37-token prompt) is masked
//     in the kernel: keys past tk count as -inf, rows past tq are not
//     stored.  There is no fallback to a plain path for any length.
// Blocks carry nothing between them, so a CTA's rows are independent:
// the launch needs no scratch and allocates nothing.

#include <math.h>

#include "common.cuh"

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

extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             const void* qseg, const void* kseg, void* o,
                             void* lse, int b, int h, int h_kv, int tq,
                             int tk, int d, int dtype, int causal,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hvd::kBF16 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, qseg, kseg, o, lse, b, h,
                                      h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kBF16 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, qseg, kseg, o, lse, b, h,
                                     h_kv, tq, tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 128)
    return launch<float, 128>(q, k, v, qseg, kseg, o, lse, b, h, h_kv, tq,
                              tk, causal, scale, s);
  if (dtype == hvd::kF32 && d == 64)
    return launch<float, 64>(q, k, v, qseg, kseg, o, lse, b, h, h_kv, tq,
                             tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
