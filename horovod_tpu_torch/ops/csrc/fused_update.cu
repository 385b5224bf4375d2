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
// card's balance point, so they stay on the CUDA cores in f32 and only
// bytes in flight and fewer passes help.  At ResNet-50's larger bucket
// (m = c = 3880, 15.1 M elements) stage 1 with a residual and stage 3 move
// 12 bytes an element (181 MB, 54 us at 3.35 TB/s) and stage 2 four (60 MB,
// 18 us).  The designs:
//   * stage 1 is a persistent grid, one CTA of 16 warps on each SM, whose
//     warps walk the rows: one warp owns a whole row of the [m, c] view,
//     so the row's r sums end in warp shuffles and no block barrier.  Q0
//     is staged once per CTA in shared memory (in column segments where c
//     does not fit), a column's KC = 4 factor values as one 16-byte chunk
//     under an XOR swizzle that keeps the lanes' reads conflict-free: one
//     16-byte read gives four products' factors.
//     It reads the FLAT bucket: element (i, j) is x[i * c + j], zero at
//     and past `size`, so no zero-padded copy of x or of the residual is
//     ever made; each row streams 16-byte vectors of x, the residual and
//     acc (a scalar head and tail where the row is not 16-byte aligned, as
//     at c = 3241), eight vectors a stream in flight per lane for an
//     f32 bucket, and a warp's first batch is asked for before Q0 is
//     staged;
//   * stage 2's Gram-Schmidt runs on one CTA of 1024 threads with P's
//     rows in registers (r <= 8, m <= 4096), else in shared memory while
//     P fits in 220 KB, else in place in device memory.  Every reduction
//     is warp shuffles, then the warps' sums, with one barrier
//     (double-buffered partials);
//   * stage 2's projection acc^T @ P_orth runs one cluster of 8 CTAs per
//     64-column tile (16-byte loads where c % 4 == 0, else coalesced 4-byte
//     ones): the 8 CTAs split the rows, each warp keeps 8 row segments in
//     flight, the chunk's P_orth rows are staged in shared memory, and the
//     8 partials are added over distributed shared memory in rank order --
//     no workspace and no finishing launch.  It is a programmatic dependent
//     launch of the Gram-Schmidt kernel: its CTAs are resident, and with
//     16-byte loads have their first rows of acc in flight, before P_orth
//     exists;
//   * stage 3 is elementwise, with the r-term sums in registers; it writes
//     out and the residual at the bucket's flat length, so no [:size] copy
//     follows;
//   * no atomics anywhere: every sum has one fixed order, so each stage
//     gives bitwise the same result from run to run and every rank that
//     holds the same allreduced factors rebuilds bitwise the same output;
//   * r is any rank >= 1: stages 1 and 2b loop over r in passes of KC = 4
//     factor columns (zero columns past r), stage 3 over r itself;
//   * the scalings and the residual subtraction use the _rn intrinsics,
//     which the compiler never contracts into an FMA, so acc, the scaling
//     order of out and the residual's last subtraction round as the plain
//     PyTorch version's separate operations do.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using hvd::mma::cp_async4;
using hvd::mma::smem_addr;

// Every cp.async of this thread has landed.
__device__ __forceinline__ void cp_async_drain() {
  hvd::mma::cp_async_commit();
  hvd::mma::cp_async_wait<0>();
}

constexpr int NT = 256;           // threads per CTA, stages 2b and 3
constexpr int GS_NT = 1024;       // threads per Gram-Schmidt CTA
constexpr int GS_RPT = 4;         // Gram-Schmidt in registers: rows a thread
constexpr int GS_R = 8;           // ... and factor columns at most
constexpr int QCL = 8;            // stage 2b: CTAs (row chunks) a cluster
constexpr int KC = 4;             // stages 1 and 2b: factor columns a pass
constexpr int LPR = 16;           // stage 2b: lanes across one row
constexpr int SLOTS = NT / LPR;   // stage 2b: row slots a CTA
constexpr int TILE = 4 * LPR;     // stage 2b: columns a cluster
constexpr int P_STAGE = 2048;     // stage 2b: staged P_orth floats
constexpr int GS_SMEM = 220 * 1024;  // Gram-Schmidt: P bytes in shared memory
constexpr int MP_NT = 512;        // stage 1: threads a CTA, one an SM
constexpr int MP_WARPS = MP_NT / 32;
constexpr int MP_SMEM = 112 * 1024;  // stage 1: Q0 bytes a CTA

// --- thread block clusters (sm_90) -----------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster; orders shared-memory writes
// before it against distributed reads after it.  Not `.aligned`: a warp
// may arrive diverged.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// The float at `p` (this CTA's shared memory) in the CTA of rank `rank`.
__device__ __forceinline__ float ld_cluster(const float* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned ra;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(ra) : "memory");
  return v;
}

// --- 16-byte vectors ---------------------------------------------------------

__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float* __restrict__ dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float* __restrict__ dst) {
  hvd::load8(p, dst);
}

// n (a multiple of 4) f32 at a 16-byte aligned address.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* dst) {
#pragma unroll
  for (int v = 0; v < N / 4; ++v) load_vec(p + 4 * v, dst + 4 * v);
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* src) {
#pragma unroll
  for (int v = 0; v < N / 4; ++v)
    reinterpret_cast<float4*>(p)[v] = make_float4(
        src[4 * v], src[4 * v + 1], src[4 * v + 2], src[4 * v + 3]);
}

// --- Stage 1 -----------------------------------------------------------------

// Q0's slice in shared memory: column j's KC factor values are one
// 16-byte chunk, at chunk slot swz(j).  Lanes read columns VE apart, one
// chunk each; XOR-ing a chunk's low three bits with the next three spreads
// a quarter-warp's chunks over all 32 banks.  The XOR stays in the chunk's
// aligned block of 8, so a slice of n chunks needs round_up(n, 8) slots.
__device__ __forceinline__ int swz(int chunk) {
  return chunk ^ ((chunk >> 3) & 7);
}

// acc element f of the flat bucket: x * prescale (+ residual), each
// rounded as the plain version's separate operations.
template <typename T>
__device__ __forceinline__ float first_value(const T* __restrict__ x,
                                             const float* __restrict__ res,
                                             int64_t f, float prescale) {
  float a = hvd::to_float(x[f]);
  if (prescale != 1.f) a = __fmul_rn(a, prescale);
  if (res != nullptr) a = __fadd_rn(a, res[f]);
  return a;
}

// Persistent grid; warp w of CTA b owns rows b * MP_WARPS + w, then every
// gridDim.x * MP_WARPS further.  For each pass of KC factor columns and each
// segment of `seg_cols` columns, the CTA stages Q0's slice, and each warp
// sums its rows' products with it.  Pass 0 computes acc from x and the
// residual and writes it (the pad past `size` as zeros); later passes
// re-read acc.  `vec`: x, the residual and acc share their 16-byte phase
// (`phase`: x's element offset modulo VE), so each row streams VE-element
// vectors between a scalar head and tail.  A row's sums: each lane in its
// element order, then xor-shuffles; a later segment adds to p.
template <typename T>
__global__ void __launch_bounds__(MP_NT, 1)
    matricize_p_kernel(const T* __restrict__ x, const float* __restrict__ res,
                       const float* __restrict__ q0, float* acc,
                       float* __restrict__ p, int64_t size, int m, int c,
                       int r, int seg_cols, float prescale, int vec,
                       int phase, int q16) {
  constexpr int VE = 16 / sizeof(T);   // elements a 16-byte load of x
  constexpr int U = 32 / VE;           // x vectors a lane has in flight
  extern __shared__ __align__(16) float q_s[];  // swizzled [cols][KC]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // Row i's segment from column j0: flat [f0, f0 + cols), live below fe;
  // `nvec` vectors from f0 + head.
  struct Span {
    int64_t f0, fe, head, nvec;
  };
  auto span = [&](int i, int j0, int cols) {
    Span sp;
    sp.f0 = static_cast<int64_t>(i) * c + j0;
    const int64_t fend = sp.f0 + cols;
    sp.fe = fend < size ? fend : (sp.f0 < size ? size : sp.f0);
    sp.head = sp.nvec = 0;
    if (vec) {
      sp.head = (VE - (sp.f0 + phase) % VE) % VE;
      if (sp.head > sp.fe - sp.f0) sp.head = sp.fe - sp.f0;
      sp.nvec = (sp.fe - sp.f0 - sp.head) / VE;
    }
    return sp;
  };
  float a[U][VE], rv[U][VE];
  // The lane's vectors vb + lane + 32 u (u < U) of a span from fb: x and
  // the residual in pass 0, else acc.
  auto load_batch = [&](int64_t fb, int64_t vb, int64_t nvec, bool first) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = vb + lane + 32 * u;
      if (v < nvec) {
        if (first) {
          load_vec(x + fb + v * VE, a[u]);
        } else {
          load_f32<VE>(acc + fb + v * VE, a[u]);
        }
      }
    }
    if (first && res != nullptr) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t v = vb + lane + 32 * u;
        if (v < nvec) load_f32<VE>(res + fb + v * VE, rv[u]);
      }
    }
  };
  // The warp's first vectors are asked for before Q0 is staged, so that
  // the staging's latency overlaps the stream.
  bool preloaded = false;
  const int i_first = blockIdx.x * MP_WARPS + warp;
  if (i_first < m) {
    const Span sp = span(i_first, 0, c < seg_cols ? c : seg_cols);
    if (sp.nvec > 0) {
      load_batch(sp.f0 + sp.head, 0, sp.nvec, true);
      preloaded = true;
    }
  }
  for (int k0 = 0; k0 < r; k0 += KC) {
    const int nk = r - k0 < KC ? r - k0 : KC;
    for (int j0 = 0; j0 < c; j0 += seg_cols) {
      const int cols = c - j0 < seg_cols ? c - j0 : seg_cols;
      __syncthreads();  // the previous slice is no longer read
      // All in flight at once: 16 bytes a copy where the slice is whole
      // 16-byte aligned rows of Q0 (`q16`: r == KC), else 4 (zero past r).
      if (q16) {
        for (int ch = threadIdx.x; ch < cols; ch += MP_NT)
          hvd::mma::cp_async16(smem_addr(&q_s[4 * swz(ch)]),
                               q0 + static_cast<int64_t>(j0) * r + 4 * ch,
                               true);
      } else {
        for (int e = threadIdx.x; e < cols * KC; e += MP_NT) {
          const int j = e / KC, k = e % KC;
          cp_async4(smem_addr(&q_s[4 * swz(j) + k]),
                    q0 + static_cast<int64_t>(j0 + j) * r + k0 +
                        (k < nk ? k : 0),
                    k < nk);
        }
      }
      cp_async_drain();
      __syncthreads();
      for (int i = i_first; i < m; i += gridDim.x * MP_WARPS) {
        const Span sp = span(i, j0, cols);
        const int64_t f0 = sp.f0, fe = sp.fe, fend = f0 + cols;
        const int64_t head = sp.head, nvec = sp.nvec;
        float s[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) s[k] = 0.f;
        auto add = [&](float val, int j) {
          const float4 q = *reinterpret_cast<const float4*>(&q_s[4 * swz(j)]);
          s[0] += val * q.x;
          s[1] += val * q.y;
          s[2] += val * q.z;
          s[3] += val * q.w;
        };
        auto scalar = [&](int64_t f) {
          float val;
          if (k0 == 0) {
            val = first_value(x, res, f, prescale);
            acc[f] = val;
          } else {
            val = acc[f];
          }
          add(val, static_cast<int>(f - f0));
        };
        if (lane < head) scalar(f0 + lane);
        const int64_t fb = f0 + head;
        for (int64_t vb = 0; vb < nvec; vb += 32 * U) {
          // The first batch of the warp's first row came before staging.
          if (preloaded) {
            preloaded = false;
          } else {
            load_batch(fb, vb, nvec, k0 == 0);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t v = vb + lane + 32 * u;
            if (v < nvec) {
              const int64_t f = fb + v * VE;
              if (k0 == 0) {
#pragma unroll
                for (int e = 0; e < VE; ++e) {
                  if (prescale != 1.f) a[u][e] = __fmul_rn(a[u][e], prescale);
                  if (res != nullptr) a[u][e] = __fadd_rn(a[u][e], rv[u][e]);
                }
                store_f32<VE>(acc + f, a[u]);
              }
              const int j = static_cast<int>(f - f0);
#pragma unroll
              for (int e = 0; e < VE; ++e) add(a[u][e], j + e);
            }
          }
        }
        for (int64_t f = fb + nvec * VE + lane; f < fe; f += 32) scalar(f);
        if (k0 == 0)
          for (int64_t f = fe + lane; f < fend; f += 32) acc[f] = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (k < nk) {
            const float t = hvd::warp_sum(s[k]);
            if (lane == 0) {
              float* out = p + static_cast<int64_t>(i) * r + k0 + k;
              *out = j0 == 0 ? t : __fadd_rn(*out, t);
            }
          }
        }
      }
    }
  }
}

// --- Stage 2a: Gram-Schmidt --------------------------------------------------

// Sum of v over every thread of the CTA, the same total in each:
// xor-shuffles within each warp, then the warps' sums by the same
// xor-shuffle tree in every warp.  One barrier a call: the partials
// alternate between two buffers.
__device__ __forceinline__ float gs_sum(float v, float (*part)[32], int& buf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = hvd::warp_sum(v);
  if (lane == 0) part[buf][warp] = v;
  __syncthreads();
  const float t = hvd::warp_sum(lane < GS_NT / 32 ? part[buf][lane] : 0.f);
  buf ^= 1;
  return t;
}

// The Gram-Schmidt below with the rows in registers, for r <= GS_R and
// m <= GS_NT * GS_RPT (every bucket up to 16.7 M elements, ResNet-50's two
// among them): thread t owns rows t, t + GS_NT, ... in the same order, so
// only the reductions touch shared memory.
__global__ void __launch_bounds__(GS_NT)
    gram_schmidt_regs_kernel(const float* __restrict__ p,
                             float* __restrict__ po, int m, int r) {
  __shared__ float part[2][32];
  asm volatile("griddepcontrol.launch_dependents;");  // the projection
  float v[GS_RPT][GS_R];
#pragma unroll
  for (int t = 0; t < GS_RPT; ++t) {
    const int i = threadIdx.x + t * GS_NT;
#pragma unroll
    for (int k = 0; k < GS_R; ++k)
      v[t][k] = i < m && k < r ? p[static_cast<int64_t>(i) * r + k] : 0.f;
  }
  int buf = 0;
#pragma unroll
  for (int k = 0; k < GS_R; ++k) {
    if (k < r) {
      float d = 0.f;
#pragma unroll
      for (int u = 0; u <= k; ++u) {
        float part_sum = 0.f;
#pragma unroll
        for (int t = 0; t < GS_RPT; ++t) {
          if (u > 0) v[t][k] = __fsub_rn(v[t][k], __fmul_rn(d, v[t][u - 1]));
          part_sum += (u < k ? v[t][u] : v[t][k]) * v[t][k];
        }
        d = gs_sum(part_sum, part, buf);
      }
      const float den = fmaxf(sqrtf(d), 1e-12f);
#pragma unroll
      for (int t = 0; t < GS_RPT; ++t) v[t][k] = __fdiv_rn(v[t][k], den);
    }
  }
#pragma unroll
  for (int t = 0; t < GS_RPT; ++t) {
    const int i = threadIdx.x + t * GS_NT;
#pragma unroll
    for (int k = 0; k < GS_R; ++k)
      if (i < m && k < r) po[static_cast<int64_t>(i) * r + k] = v[t][k];
  }
}

// po = modified Gram-Schmidt of p's columns ([m, r]) in _gram_schmidt's
// order: column k minus its projections on the finished columns 0..k-1,
// one after another, then divided by max(norm, 1e-12).  One CTA; a thread
// owns rows tid, tid + GS_NT, ..., so only the dot products cross
// threads.  `in_smem`: P sits column by column in shared memory; else it
// is worked on in place in po.
__global__ void __launch_bounds__(GS_NT)
    gram_schmidt_kernel(const float* __restrict__ p, float* __restrict__ po,
                        int m, int r, int in_smem) {
  extern __shared__ float p_s[];
  __shared__ float part[2][32];
  asm volatile("griddepcontrol.launch_dependents;");  // the projection
  float* base = in_smem ? p_s : po;
  const int cs = in_smem ? m : 1;   // strides: column, row
  const int rs = in_smem ? 1 : r;
  auto at = [&](int k, int i) -> float& { return base[k * cs + i * rs]; };
  // Flat element e = i * r + k of P, walked without a division.
  const int n = m * r, di = GS_NT / r, dk = GS_NT % r;
  for (int e = threadIdx.x, i = e / r, k = e % r; e < n; e += GS_NT) {
    if (in_smem) {
      cp_async4(smem_addr(&at(k, i)), p + e, true);
    } else {
      at(k, i) = p[e];
    }
    i += di;
    k += dk;
    if (k >= r) k -= r, ++i;
  }
  cp_async_drain();
  __syncthreads();
  int buf = 0;
  for (int k = 0; k < r; ++k) {
    // Step u < k: the dot product of finished column u with column k,
    // in the same pass over the rows as column k's update by step u - 1;
    // step k: the norm.
    float d = 0.f;
    for (int u = 0; u <= k; ++u) {
      float part_sum = 0.f;
      for (int i = threadIdx.x; i < m; i += GS_NT) {
        float v = at(k, i);
        if (u > 0) {
          v = __fsub_rn(v, __fmul_rn(d, at(u - 1, i)));
          at(k, i) = v;
        }
        part_sum += (u < k ? at(u, i) : v) * v;
      }
      d = gs_sum(part_sum, part, buf);
    }
    const float den = fmaxf(sqrtf(d), 1e-12f);
    for (int i = threadIdx.x; i < m; i += GS_NT)
      at(k, i) = __fdiv_rn(at(k, i), den);
  }
  if (in_smem) {
    __syncthreads();
    for (int e = threadIdx.x, i = e / r, k = e % r; e < n; e += GS_NT) {
      po[e] = at(k, i);
      i += di;
      k += dk;
      if (k >= r) k -= r, ++i;
    }
  }
}

// --- Stage 2b: the projection ------------------------------------------------

// q_local[j][k] = sum over i of acc[i][j] * po[i][k].  One cluster of QCL
// CTAs per tile of TILE columns; CTA rank q sums rows [q * per, (q + 1) *
// per).  A thread owns 4 columns of one of SLOTS row slots (half a warp
// across a row) -- 4 neighbours read as one 16-byte vector where rows are
// 16-byte aligned (V4), else columns LPR apart read as 4 coalesced scalars
// -- with U rows of its slot in flight; po's rows are staged in shared
// memory P_STAGE / KC rows at a time.  Launched as a programmatic dependent of
// the Gram-Schmidt kernel: the CTAs are launched and resident while it
// runs, and wait for po.  Sums: each thread in row order,
// the slots in slot order, the CTAs in rank order.
template <bool V4>
__global__ void __launch_bounds__(NT)
    q_project_kernel(const float* __restrict__ acc,
                     const float* __restrict__ po,
                     float* __restrict__ q_local, int m, int c, int r) {
  constexpr int U = 4;
  constexpr int STAGE_ROWS = P_STAGE / KC;
  __shared__ __align__(16) float p_s[P_STAGE];
  __shared__ float slot_sum[SLOTS * TILE * KC];
  __shared__ float cta_part[TILE * KC];
  const unsigned rank = cluster_rank();
  const int slot = threadIdx.x / LPR, lc = threadIdx.x % LPR;
  const int tile0 = blockIdx.x / QCL * TILE;
  int col[4];  // this thread's columns within the tile
#pragma unroll
  for (int v = 0; v < 4; ++v) col[v] = V4 ? 4 * lc + v : lc + LPR * v;
  const int per = (m + QCL - 1) / QCL;
  const int i0 = static_cast<int>(rank) * per;
  const int i1 = i0 + per < m ? i0 + per : m;
  const float* base = acc + tile0 + col[0];
  float a[U][4];
  // Rows ib + u * SLOTS (u < U) of this thread's slot, below b1.
  auto load_rows = [&](int ib, int b1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = ib + u * SLOTS;
      const float* row = base + static_cast<int64_t>(i) * c;
      if constexpr (V4) {
        if (i < b1 && tile0 + col[0] < c) {
          load_vec(row, a[u]);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) a[u][v] = 0.f;
        }
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          a[u][v] = i < b1 && tile0 + col[v] < c ? row[col[v] - col[0]] : 0.f;
      }
    }
  };
  // acc does not depend on the Gram-Schmidt kernel: with 16-byte loads,
  // the first rows are asked for before waiting on it (the 4-byte loads
  // of the other path, asked for that early, ran slower on an H100).
  bool preloaded = V4 && i0 + slot < i1;
  if (preloaded)
    load_rows(i0 + slot, i0 + STAGE_ROWS < i1 ? i0 + STAGE_ROWS : i1);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // po is written
  for (int k0 = 0; k0 < r; k0 += KC) {
    const int nk = r - k0 < KC ? r - k0 : KC;
    float s[4][KC];
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int k = 0; k < KC; ++k) s[v][k] = 0.f;
    for (int b0 = i0; b0 < i1; b0 += STAGE_ROWS) {
      const int b1 = b0 + STAGE_ROWS < i1 ? b0 + STAGE_ROWS : i1;
      __syncthreads();  // the previous rows are no longer read
      for (int e = threadIdx.x; e < (b1 - b0) * KC; e += NT) {
        const int k = e % KC;
        cp_async4(smem_addr(&p_s[e]),
                  po + static_cast<int64_t>(b0 + e / KC) * r + k0 +
                      (k < nk ? k : 0),
                  k < nk);
      }
      cp_async_drain();
      __syncthreads();
      for (int ib = b0 + slot; ib < b1; ib += SLOTS * U) {
        if (preloaded) {
          preloaded = false;
        } else {
          load_rows(ib, b1);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = ib + u * SLOTS;
          if (i < b1) {
            const float* pr = p_s + (i - b0) * KC;
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              const float pk = pr[k];
#pragma unroll
              for (int v = 0; v < 4; ++v) s[v][k] += a[u][v] * pk;
            }
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int k = 0; k < KC; ++k)
        slot_sum[(slot * TILE + col[v]) * KC + k] = s[v][k];
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * KC; e += NT) {
      float t = 0.f;
      for (int sl = 0; sl < SLOTS; ++sl) t += slot_sum[sl * TILE * KC + e];
      cta_part[e] = t;
    }
    cluster_sync();
    for (int e = static_cast<int>(rank) * NT + threadIdx.x; e < TILE * KC;
         e += QCL * NT) {
      const int jj = tile0 + e / KC, k = e % KC;
      if (jj < c && k < nk) {
        float t = 0.f;
        for (unsigned q = 0; q < QCL; ++q) t += ld_cluster(&cta_part[e], q);
        q_local[static_cast<int64_t>(jj) * r + k0 + k] = t;
      }
    }
    cluster_sync();  // cta_part is read before it is rewritten or freed
  }
}

// --- Stage 3 -----------------------------------------------------------------

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

// --- Launch helpers ----------------------------------------------------------

bool bad_dims(int64_t size, int m, int c, int r) {
  return m < 1 || c < 1 || r < 1 || size < 1 ||
         size > static_cast<int64_t>(m) * c;
}

// Opt `kernel` into `bytes` of dynamic shared memory (needed above 48 KB),
// once for each size it grows to.
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// The SMs of the current device, asked once for each device.
cudaError_t sm_count(int* sms) {
  constexpr int MAX_DEVICES = 64;
  static int known[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) known[dev] = *sms;
  return err;
}

template <typename T>
int launch_matricize_p(const T* x, const float* res, const float* q0,
                       float* acc, float* p, int64_t size, int m, int c,
                       int r, float prescale, cudaStream_t s) {
  constexpr int VE = 16 / sizeof(T);
  // Column segments of Q0 that fit MP_SMEM, a multiple of 32 columns.
  int seg = MP_SMEM / (KC * 4) / 32 * 32;
  if (seg > c) seg = c;
  const size_t smem = static_cast<size_t>((seg + 7) & ~7) * 16;
  cudaError_t err = allow_smem<matricize_p_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  // One CTA an SM (its 512 threads hold the SM's registers).
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  int grid = (m + MP_WARPS - 1) / MP_WARPS;
  if (grid > sms) grid = sms;
  // 16-byte vectors where x, the residual and acc share their phase.
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int phase = static_cast<int>((xa / sizeof(T)) % VE);
  bool vec = xa % sizeof(T) == 0 &&
             reinterpret_cast<uintptr_t>(acc) / 4 % 4 ==
                 static_cast<uintptr_t>(phase % 4) &&
             reinterpret_cast<uintptr_t>(acc) % 4 == 0;
  if (res != nullptr) {
    const uintptr_t ra = reinterpret_cast<uintptr_t>(res);
    vec = vec && ra % 4 == 0 && ra / 4 % 4 == static_cast<uintptr_t>(phase % 4);
  }
  const bool q16 = r == KC && reinterpret_cast<uintptr_t>(q0) % 16 == 0;
  matricize_p_kernel<T><<<grid, MP_NT, smem, s>>>(
      x, res, q0, acc, p, size, m, c, r, seg, prescale, vec ? 1 : 0, phase,
      q16 ? 1 : 0);
  return cudaGetLastError();
}

// Clusters of QCL CTAs along x, as a programmatic dependent of the
// stream's previous kernel (it may start once that kernel's CTAs have all
// run griddepcontrol.launch_dependents, and waits for that kernel's writes
// at its griddepcontrol.wait).
template <bool V4>
int launch_q_project(const float* acc, const float* po, float* ql, int m,
                     int c, int r, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c + TILE - 1) / TILE * QCL);
  cfg.blockDim = dim3(NT);
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = QCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, q_project_kernel<V4>, acc, po, ql, m, c, r);
}

// Gram-Schmidt on one CTA, P in shared memory where it fits, else in
// device memory.
cudaError_t gram_schmidt_any(const float* p, float* po, int m, int r,
                             cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(m) * r * sizeof(float);
  const bool in_smem = bytes <= GS_SMEM;
  const size_t smem = in_smem ? bytes : 0;
  const cudaError_t err = allow_smem<gram_schmidt_kernel>(smem);
  if (err != cudaSuccess) return err;
  gram_schmidt_kernel<<<1, GS_NT, smem, s>>>(p, po, m, r, in_smem ? 1 : 0);
  return cudaGetLastError();
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
  const float* qp = static_cast<const float*>(q0);
  float* ap = static_cast<float*>(acc);
  float* pp = static_cast<float*>(p);
  if (dtype == hvd::kBF16)
    return launch_matricize_p(static_cast<const __nv_bfloat16*>(x), rp, qp,
                              ap, pp, size, m, c, r, prescale, s);
  if (dtype == hvd::kF32)
    return launch_matricize_p(static_cast<const float*>(x), rp, qp, ap, pp,
                              size, m, c, r, prescale, s);
  return cudaErrorInvalidValue;
}

// Stage 2: po ([m, r]) = Gram-Schmidt of the mean p ([m, r]), and q_local
// ([c, r]) = acc^T @ po.  Two launches on `stream`; returns the CUDA error
// of the first that fails.
extern "C" int hvd_fused_orthonormalize_q(const void* acc, const void* p,
                                          void* po, void* q_local, int m,
                                          int c, int r, void* stream) {
  if (bad_dims(1, m, c, r)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  float* pop = static_cast<float*>(po);
  cudaError_t err;
  if (r <= GS_R && m <= GS_NT * GS_RPT) {
    gram_schmidt_regs_kernel<<<1, GS_NT, 0, s>>>(pp, pop, m, r);
    err = cudaGetLastError();
  } else {
    err = gram_schmidt_any(pp, pop, m, r, s);
  }
  if (err != cudaSuccess) return err;
  const float* ap = static_cast<const float*>(acc);
  float* qlp = static_cast<float*>(q_local);
  if (c % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0)
    return launch_q_project<true>(ap, pop, qlp, m, c, r, s);
  return launch_q_project<false>(ap, pop, qlp, m, c, r, s);
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
