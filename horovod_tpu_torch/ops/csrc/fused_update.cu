// The three stages of the fused PowerSGD + error-feedback exchange for
// Hopper (sm_90a), between its two factor allreduces.
//
// Replaces: horovod_tpu/ops/fused_update.py, whose Pallas TPU kernels are
//   * matricize_p (_matricize_p_kernel / _matricize_p_res_kernel): acc =
//     x * prescale (+ residual) in f32 over the [m, c] matricized bucket,
//     and P = acc @ Q0 ([m, r]);
//   * orthonormalize_q (_orthonormalize_q_kernel + _gram_schmidt): one
//     modified Gram-Schmidt round over the allreduced mean P, computed once
//     at grid step 0 into VMEM scratch, and Q_local = acc^T @ P_orth
//     ([c, r]) over a sequential grid of column blocks;
//   * reconstruct_residual (_reconstruct_kernel): out = (P_orth Q^T) *
//     n_scale * postscale and residual = acc - P_orth Q_local^T.
// Same functions, same f32 arithmetic; x is the flat bucket in its own type
// (f32 or bf16), every other array is f32.
//
// What bounds it on the H100: memory.  Each stage makes one pass over the
// [m, c] arena and does 2 r f32 operations an element against 4 to 12
// bytes moved -- at r = 4 about 0.7 operations a byte, far below the
// card's balance point.  At ResNet-50's larger bucket (m = c = 3880, 15.1 M
// elements) stage 1 with a residual and stage 3 move 12 bytes an element
// (181 MB, 54 us at 3.35 TB/s) and stage 2 four (60 MB, 18 us).  This first
// version is the simple one; what it does about the bound and the TPU
// design:
//   * stage 1 reads the FLAT bucket: a CTA owns one row i of the [m, c]
//     view and element (i, j) is x[i * c + j], zero at and past `size`, so
//     no zero-padded copy of x or of the residual is ever made.  It writes
//     acc at [m, c] (the pad as zeros, which stages 2 and 3 read) and sums
//     its row's r products with Q0 in registers, then over the CTA in a
//     fixed order (warp shuffles, then the warps in index order);
//   * stage 2's Gram-Schmidt is a strict sequence of r (r + 1) / 2 dot
//     products over m rows: one CTA of 1024 threads runs it in
//     _gram_schmidt's order, each reduction in a fixed order, with its
//     max(norm, 1e-12).  The projection acc^T @ P_orth cannot carry sums
//     across a grid as the Pallas kernel does: CTAs over (128-column tile,
//     row chunk) write [chunks, c, r] partials (c / 128 = 31 tiles alone
//     would leave most of the 132 SMs idle), and a small finishing launch
//     sums them in chunk order -- the pattern of bn_bwd.cu;
//   * stage 3 is elementwise, with the r-term sums in registers; it writes
//     out and the residual at the bucket's flat length, so no [:size] copy
//     follows;
//   * no atomics anywhere: every sum has one fixed order, so each stage
//     gives bitwise the same result from run to run and every rank that
//     holds the same allreduced factors rebuilds bitwise the same output;
//   * r is any rank >= 1: a thread holds RC factor columns in registers and
//     the kernels loop over r in passes of RC (one pass at r <= 8);
//   * the scalings and the residual subtraction use the _rn intrinsics,
//     which the compiler never contracts into an FMA, so acc, the scaling
//     order of out and the residual's last subtraction round as the plain
//     PyTorch version's separate operations do.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per CTA, stages 1, 2b and 3
constexpr int GS_NT = 1024;      // threads of the one Gram-Schmidt CTA
constexpr int RC = 8;            // factor columns a thread sums per pass
constexpr int TILE = 128;        // stage 2b: columns per CTA
constexpr int SLOTS = NT / TILE;  // stage 2b: row slots per CTA

// Fixed-order sum of v[0..nk) over the CTA's threads: xor-shuffles within
// each warp, then the warps' sums added in warp order by every thread (all
// of them get the same total).  `part` holds [warps][RC] floats.
template <int THREADS>
__device__ __forceinline__ void block_sum(float* v, int nk, float* part) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < RC; ++k) {
    if (k < nk) {
      const float s = hvd::warp_sum(v[k]);
      if (lane == 0) part[warp * RC + k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RC; ++k) {
    if (k < nk) {
      float t = 0.f;
      for (int w = 0; w < WARPS; ++w) t += part[w * RC + k];
      v[k] = t;
    }
  }
  __syncthreads();  // `part` may be reused right after
}

// Stage 1, one CTA per row i of the [m, c] view.
template <typename T>
__global__ void __launch_bounds__(NT)
    matricize_p_kernel(const T* __restrict__ x, const float* __restrict__ res,
                       const float* __restrict__ q0, float* __restrict__ acc,
                       float* __restrict__ p, int64_t size, int c, int r,
                       float prescale) {
  __shared__ float part[(NT / 32) * RC];
  const int i = blockIdx.x;
  const int64_t row = static_cast<int64_t>(i) * c;
  for (int k0 = 0; k0 < r; k0 += RC) {
    const int nk = r - k0 < RC ? r - k0 : RC;
    float s[RC];
#pragma unroll
    for (int k = 0; k < RC; ++k) s[k] = 0.f;
    for (int j = threadIdx.x; j < c; j += NT) {
      const int64_t f = row + j;
      float a;
      if (k0 == 0) {
        a = 0.f;
        if (f < size) {
          a = hvd::to_float(x[f]);
          if (prescale != 1.f) a = __fmul_rn(a, prescale);
          if (res != nullptr) a = __fadd_rn(a, res[f]);
        }
        acc[f] = a;
      } else {
        a = acc[f];  // this thread's own write of the first pass
      }
      const float* qj = q0 + static_cast<int64_t>(j) * r + k0;
#pragma unroll
      for (int k = 0; k < RC; ++k)
        if (k < nk) s[k] += a * qj[k];
    }
    block_sum<NT>(s, nk, part);
    if (threadIdx.x < nk)
      p[static_cast<int64_t>(i) * r + k0 + threadIdx.x] = s[threadIdx.x];
  }
}

// Stage 2a, one CTA: po = modified Gram-Schmidt of p's columns ([m, r]),
// _gram_schmidt's order: column k minus its projections on the finished
// columns 0..k-1 one after another, then divided by max(norm, 1e-12).  A
// thread owns rows tid, tid + GS_NT, ...; only the dot products cross
// threads.
__global__ void __launch_bounds__(GS_NT)
    gram_schmidt_kernel(const float* __restrict__ p, float* __restrict__ po,
                        int m, int r) {
  __shared__ float part[(GS_NT / 32) * RC];
  for (int k = 0; k < r; ++k) {
    for (int i = threadIdx.x; i < m; i += GS_NT)
      po[static_cast<int64_t>(i) * r + k] = p[static_cast<int64_t>(i) * r + k];
    for (int u = 0; u < k; ++u) {
      float d[RC];
      d[0] = 0.f;
      for (int i = threadIdx.x; i < m; i += GS_NT) {
        const float* row = po + static_cast<int64_t>(i) * r;
        d[0] += row[u] * row[k];
      }
      block_sum<GS_NT>(d, 1, part);
      for (int i = threadIdx.x; i < m; i += GS_NT) {
        float* row = po + static_cast<int64_t>(i) * r;
        row[k] = __fsub_rn(row[k], __fmul_rn(d[0], row[u]));
      }
    }
    float nn[RC];
    nn[0] = 0.f;
    for (int i = threadIdx.x; i < m; i += GS_NT) {
      const float v = po[static_cast<int64_t>(i) * r + k];
      nn[0] += v * v;
    }
    block_sum<GS_NT>(nn, 1, part);
    const float den = fmaxf(sqrtf(nn[0]), 1e-12f);
    for (int i = threadIdx.x; i < m; i += GS_NT) {
      float* v = po + static_cast<int64_t>(i) * r + k;
      *v = __fdiv_rn(*v, den);
    }
  }
}

// Stage 2b, per (128-column tile, row chunk): partial[chunk][j][k] = sum
// over the chunk's rows i of acc[i][j] * po[i][k].  A warp reads 32
// neighbouring columns of one row; the CTA's two row slots are added in
// slot order.
__global__ void __launch_bounds__(NT)
    q_partial_kernel(const float* __restrict__ acc,
                     const float* __restrict__ po,
                     float* __restrict__ partial, int m, int c, int r,
                     int rows_per_chunk) {
  __shared__ float slot_sum[SLOTS][TILE][RC];
  const int col = threadIdx.x % TILE, slot = threadIdx.x / TILE;
  const int j = blockIdx.x * TILE + col;
  const int i0 = blockIdx.y * rows_per_chunk;
  const int i1 = i0 + rows_per_chunk < m ? i0 + rows_per_chunk : m;
  for (int k0 = 0; k0 < r; k0 += RC) {
    const int nk = r - k0 < RC ? r - k0 : RC;
    float s[RC];
#pragma unroll
    for (int k = 0; k < RC; ++k) s[k] = 0.f;
    if (j < c) {
      for (int i = i0 + slot; i < i1; i += SLOTS) {
        const float a = acc[static_cast<int64_t>(i) * c + j];
        const float* pi = po + static_cast<int64_t>(i) * r + k0;
#pragma unroll
        for (int k = 0; k < RC; ++k)
          if (k < nk) s[k] += a * pi[k];
      }
    }
#pragma unroll
    for (int k = 0; k < RC; ++k) slot_sum[slot][col][k] = s[k];
    __syncthreads();
    if (slot == 0 && j < c) {
      float* out = partial +
                   (static_cast<int64_t>(blockIdx.y) * c + j) * r + k0;
      for (int k = 0; k < nk; ++k) {
        float t = 0.f;
        for (int sl = 0; sl < SLOTS; ++sl) t += slot_sum[sl][col][k];
        out[k] = t;
      }
    }
    __syncthreads();
  }
}

// Stage 2c: q_local[j][k] = sum over chunks, in chunk order, of the
// partials.  One thread per (j, k).
__global__ void __launch_bounds__(NT)
    q_finish_kernel(const float* __restrict__ partial,
                    float* __restrict__ q_local, int c, int r, int chunks) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t cr = static_cast<int64_t>(c) * r;
  if (e >= cr) return;
  float t = 0.f;
  for (int ch = 0; ch < chunks; ++ch) t += partial[ch * cr + e];
  q_local[e] = t;
}

// Stage 3, one CTA per row i, only the elements below `size`.
__global__ void __launch_bounds__(NT)
    reconstruct_kernel(const float* __restrict__ acc,
                       const float* __restrict__ po,
                       const float* __restrict__ q,
                       const float* __restrict__ ql, float* __restrict__ out,
                       float* __restrict__ res, int64_t size, int c, int r,
                       float n_scale, float postscale) {
  const int i = blockIdx.x;
  const int64_t row = static_cast<int64_t>(i) * c;
  const float* pi = po + static_cast<int64_t>(i) * r;
  for (int j = threadIdx.x; j < c; j += NT) {
    const int64_t f = row + j;
    if (f >= size) break;
    const float* qj = q + static_cast<int64_t>(j) * r;
    const float* lj = ql + static_cast<int64_t>(j) * r;
    float o = 0.f, w = 0.f;
    for (int k = 0; k < r; ++k) {
      const float pk = pi[k];
      o += pk * qj[k];
      w += pk * lj[k];
    }
    if (n_scale != 1.f) o = __fmul_rn(o, n_scale);
    if (postscale != 1.f) o = __fmul_rn(o, postscale);
    out[f] = o;
    res[f] = __fsub_rn(acc[f], w);
  }
}

bool bad_dims(int64_t size, int m, int c, int r) {
  return m < 1 || c < 1 || r < 1 || size < 1 ||
         size > static_cast<int64_t>(m) * c;
}

}  // namespace

// Stage 1: acc ([m, c] f32) and p ([m, r] f32) from the flat bucket x
// (`size` elements, dtype 0 f32 / 1 bf16), the flat f32 residual `res`
// (NULL: none) and q0 ([c, r] f32).  One launch on `stream`.
extern "C" int hvd_fused_matricize_p(const void* x, const void* res,
                                     const void* q0, void* acc, void* p,
                                     int64_t size, int m, int c, int r,
                                     float prescale, int dtype,
                                     void* stream) {
  if (bad_dims(size, m, c, r)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(res);
  if (dtype == hvd::kBF16)
    matricize_p_kernel<__nv_bfloat16><<<m, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), rp,
        static_cast<const float*>(q0), static_cast<float*>(acc),
        static_cast<float*>(p), size, c, r, prescale);
  else if (dtype == hvd::kF32)
    matricize_p_kernel<float><<<m, NT, 0, s>>>(
        static_cast<const float*>(x), rp, static_cast<const float*>(q0),
        static_cast<float*>(acc), static_cast<float*>(p), size, c, r,
        prescale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Stage 2: po ([m, r]) = Gram-Schmidt of the mean p ([m, r]), and q_local
// ([c, r]) = acc^T @ po, through `workspace` ([chunks, c, r] f32).  Three
// launches on `stream`; returns the CUDA error of the first that fails.
extern "C" int hvd_fused_orthonormalize_q(const void* acc, const void* p,
                                          void* po, void* workspace,
                                          void* q_local, int m, int c, int r,
                                          int chunks, void* stream) {
  if (bad_dims(1, m, c, r) || chunks < 1 || chunks > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_schmidt_kernel<<<1, GS_NT, 0, s>>>(static_cast<const float*>(p),
                                           static_cast<float*>(po), m, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows_per_chunk = (m + chunks - 1) / chunks;
  q_partial_kernel<<<dim3((c + TILE - 1) / TILE, chunks), NT, 0, s>>>(
      static_cast<const float*>(acc), static_cast<const float*>(po),
      static_cast<float*>(workspace), m, c, r, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t cr = static_cast<int64_t>(c) * r;
  q_finish_kernel<<<static_cast<unsigned>((cr + NT - 1) / NT), NT, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(q_local), c,
      r, chunks);
  return cudaGetLastError();
}

// Stage 3: out and res (flat, `size` f32 elements each) from acc ([m, c]),
// po ([m, r]), the mean q and this rank's q_local ([c, r]).  One launch on
// `stream`.
extern "C" int hvd_fused_reconstruct(const void* acc, const void* po,
                                     const void* q, const void* q_local,
                                     void* out, void* res, int64_t size,
                                     int m, int c, int r, float n_scale,
                                     float postscale, void* stream) {
  if (bad_dims(size, m, c, r)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reconstruct_kernel<<<m, NT, 0, s>>>(
      static_cast<const float*>(acc), static_cast<const float*>(po),
      static_cast<const float*>(q), static_cast<const float*>(q_local),
      static_cast<float*>(out), static_cast<float*>(res), size, c, r,
      n_scale, postscale);
  return cudaGetLastError();
}
