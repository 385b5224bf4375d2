// Train-mode BatchNorm backward for Hopper (sm_90a): the two passes over an
// [n, c] view (channels last, c contiguous).
//
// Replaces: horovod_tpu/ops/bn.py::_bn_bwd_kernels, whose two Pallas TPU
// kernels are _reduce_kernel (pass 1: per channel dbeta = sum(dy) and
// dgamma = sum(dy * xhat), xhat = (x - mean) * inv, summed in VMEM scratch
// across a sequential grid) and _dx_kernel (pass 2: dx = scale * inv *
// (dy - dbeta / n - xhat * dgamma / n)).  Pass 2 here divides by `count`,
// which is n for one process; with synchronized BatchNorm dbeta and dgamma
// are sums over every rank and count the global row count (the allreduce
// runs between the two passes).  Same function: x and dy are f32
// or bf16 (bf16 on the ResNet path) and are read in their own type, every
// sum is f32, mean / inv / scale come in as f32 rows, dbeta and dgamma go
// out f32 and dx in x's type.
//
// What bounds it on the H100: memory.  Pass 1 reads x and dy once (2 n c
// elements) and pass 2 reads them again and writes dx (3 n c); both do a
// handful of f32 operations per element, far below the card's balance
// point.  At ResNet-50's widest BN site (batch 256, [802816 x 256] bf16)
// that is 822 MB and 1.23 GB, 245 and 368 us at 3.35 TB/s.  This first
// version is the simple one; what it does about the bound and the TPU
// design:
//   * GPU blocks carry nothing across a grid, so pass 1 cannot keep the
//     Pallas kernel's running sums.  The rows are split into `chunks`
//     (chosen by the wrapper to fill the 132 SMs) and each CTA sums one
//     chunk of one 256-channel tile in registers; it writes [2, c] f32
//     partials for its chunk to a workspace, and a small second launch
//     sums the partials of every chunk in a fixed order.  No atomics: the
//     sums, and so every gradient, repeat bit for bit from run to run;
//   * a thread owns VEC consecutive channels and walks the rows of its
//     chunk with a stride of the CTA's row slots.  Where c % 8 == 0 and
//     the tensors are 16-byte aligned, VEC = 8 and every load (and pass
//     2's store) is one 16-byte vector; otherwise VEC = 1 (c = 3, a view
//     at an odd offset).  Neighbouring threads hold neighbouring channel
//     groups, so a warp reads contiguous bytes;
//   * pass 2 computes each channel's coefficients once per thread
//     (scale * inv, dbeta / count, dgamma / count, mean, inv) and then
//     runs one
//     vectorised elementwise pass, keeping the plain formula's order of
//     operations;
//   * row offsets are 64-bit: n * c reaches 2.1e8 at the ResNet-50 stem.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;             // threads per CTA
constexpr int TILE_CHANNELS = 256;  // channels per CTA tile
constexpr int FIN_CH = 32;          // finishing launch: channels per CTA
constexpr int FIN_PARTS = NT / FIN_CH;

template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float* __restrict__ dst) {
  if constexpr (VEC == 8) {
    hvd::load8(p, dst);
  } else {
    dst[0] = hvd::to_float(p[0]);
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float* __restrict__ src) {
  if constexpr (VEC == 8) {
    hvd::store8(p, src);
  } else {
    p[0] = hvd::from_float<T>(src[0]);
  }
}

// A CTA covers one tile of `groups` channel groups of VEC channels, side by
// side, and NT / groups row slots; `tiles` such tiles span the c channels.
template <int VEC>
struct Geometry {
  int groups, slots, tiles;
  __host__ __device__ explicit Geometry(int c) {
    const int cg = c / VEC;
    const int most = TILE_CHANNELS / VEC;
    groups = cg < most ? cg : most;
    slots = NT / groups;
    tiles = (cg + groups - 1) / groups;
  }
};

// Pass 1, per (channel tile, row chunk): f32 sums of dy and dy * xhat over
// the chunk's rows, reduced over the CTA's row slots in a fixed order and
// written as partial[chunk][0 | 1][channel].
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv,
                         float* __restrict__ partial, int64_t n, int c,
                         int64_t rows_per_chunk) {
  const Geometry<VEC> geo(c);
  const int g = threadIdx.x % geo.groups;
  const int slot = threadIdx.x / geo.groups;
  const int c0 = (blockIdx.x * geo.groups + g) * VEC;
  float sb[VEC], sg[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sb[j] = sg[j] = 0.f;
  if (slot < geo.slots && c0 < c) {
    float m[VEC], iv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = mean[c0 + j];
      iv[j] = inv[c0 + j];
    }
    const int64_t start = blockIdx.y * rows_per_chunk;
    const int64_t end =
        start + rows_per_chunk < n ? start + rows_per_chunk : n;
    for (int64_t r = start + slot; r < end; r += geo.slots) {
      const int64_t off = r * c + c0;
      float xv[VEC], dv[VEC];
      load_vec<VEC>(x + off, xv);
      load_vec<VEC>(dy + off, dv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (xv[j] - m[j]) * iv[j];
        sb[j] += dv[j];
        sg[j] += dv[j] * xhat;
      }
    }
  }
  __shared__ float red[NT][2 * VEC + 1];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[threadIdx.x][j] = sb[j];
    red[threadIdx.x][VEC + j] = sg[j];
  }
  __syncthreads();
  // One thread per channel of the tile (groups * VEC <= NT).
  const int o = threadIdx.x;
  if (o >= geo.groups * VEC) return;
  const int go = o / VEC, j = o % VEC;
  const int ch = (blockIdx.x * geo.groups + go) * VEC + j;
  if (ch >= c) return;
  float b = 0.f, s = 0.f;
  for (int k = 0; k < geo.slots; ++k) {
    b += red[k * geo.groups + go][j];
    s += red[k * geo.groups + go][VEC + j];
  }
  float* row = partial + (int64_t)blockIdx.y * 2 * c;
  row[ch] = b;
  row[c + ch] = s;
}

// Pass 1's finishing launch: per channel, the sum of every chunk's partials
// in a fixed order (FIN_PARTS interleaved slices, then the slices in turn).
__global__ void __launch_bounds__(NT)
    bn_bwd_finish_kernel(const float* __restrict__ partial,
                         float* __restrict__ dbeta,
                         float* __restrict__ dgamma, int c, int chunks) {
  const int lane = threadIdx.x % FIN_CH;
  const int part = threadIdx.x / FIN_CH;
  const int ch = blockIdx.x * FIN_CH + lane;
  float b = 0.f, s = 0.f;
  if (ch < c) {
    for (int k = part; k < chunks; k += FIN_PARTS) {
      const float* row = partial + (int64_t)k * 2 * c;
      b += row[ch];
      s += row[c + ch];
    }
  }
  __shared__ float red[2][FIN_PARTS][FIN_CH + 1];
  red[0][part][lane] = b;
  red[1][part][lane] = s;
  __syncthreads();
  if (part != 0 || ch >= c) return;
  b = 0.f;
  s = 0.f;
#pragma unroll
  for (int p = 0; p < FIN_PARTS; ++p) {
    b += red[0][p][lane];
    s += red[1][p][lane];
  }
  dbeta[ch] = b;
  dgamma[ch] = s;
}

// Pass 2: dx = (scale * inv) * ((dy - dbeta / count) -
//                                xhat * (dgamma / count)).
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const float* __restrict__ scale,
                     const float* __restrict__ dbeta,
                     const float* __restrict__ dgamma, T* __restrict__ dx,
                     int64_t n, int c, int64_t rows_per_chunk, float count) {
  const Geometry<VEC> geo(c);
  const int g = threadIdx.x % geo.groups;
  const int slot = threadIdx.x / geo.groups;
  const int c0 = (blockIdx.x * geo.groups + g) * VEC;
  if (slot >= geo.slots || c0 >= c) return;
  float m[VEC], iv[VEC], a[VEC], b[VEC], gn[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mean[c0 + j];
    iv[j] = inv[c0 + j];
    a[j] = scale[c0 + j] * iv[j];
    b[j] = dbeta[c0 + j] / count;
    gn[j] = dgamma[c0 + j] / count;
  }
  const int64_t start = blockIdx.y * rows_per_chunk;
  const int64_t end =
      start + rows_per_chunk < n ? start + rows_per_chunk : n;
  for (int64_t r = start + slot; r < end; r += geo.slots) {
    const int64_t off = r * c + c0;
    float xv[VEC], dv[VEC], out[VEC];
    load_vec<VEC>(x + off, xv);
    load_vec<VEC>(dy + off, dv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = (xv[j] - m[j]) * iv[j];
      out[j] = a[j] * ((dv[j] - b[j]) - xhat * gn[j]);
    }
    store_vec<VEC>(dx + off, out);
  }
}

bool bad_shape(int64_t n, int c, int chunks, int vec, const void* x,
               const void* dy, const void* dx) {
  if (n < 1 || c < 1 || chunks < 1 || chunks > 65535) return true;
  if (!vec) return false;
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(dy) |
                        reinterpret_cast<uintptr_t>(dx);
  return c % 8 != 0 || any % 16 != 0;
}

template <typename T, int VEC>
cudaError_t launch_reduce(const void* x, const void* dy, const void* mean,
                          const void* inv, void* workspace, void* dbeta,
                          void* dgamma, int64_t n, int c, int chunks,
                          cudaStream_t s) {
  const Geometry<VEC> geo(c);
  const int64_t rows_per_chunk = (n + chunks - 1) / chunks;
  bn_bwd_reduce_kernel<T, VEC><<<dim3(geo.tiles, chunks), NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(inv),
      static_cast<float*>(workspace), n, c, rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_finish_kernel<<<(c + FIN_CH - 1) / FIN_CH, NT, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(dbeta),
      static_cast<float*>(dgamma), c, chunks);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_dx(const void* x, const void* dy, const void* mean,
                      const void* inv, const void* scale, const void* dbeta,
                      const void* dgamma, void* dx, int64_t n, int c,
                      int chunks, float count, cudaStream_t s) {
  const Geometry<VEC> geo(c);
  const int64_t rows_per_chunk = (n + chunks - 1) / chunks;
  bn_bwd_dx_kernel<T, VEC><<<dim3(geo.tiles, chunks), NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(inv),
      static_cast<const float*>(scale), static_cast<const float*>(dbeta),
      static_cast<const float*>(dgamma), static_cast<T*>(dx), n, c,
      rows_per_chunk, count);
  return cudaGetLastError();
}

}  // namespace

// Pass 1: dbeta, dgamma ([c] f32) of x, dy ([n, c], dtype 0 f32 / 1 bf16)
// given mean and inv = rsqrt(var + eps) ([c] f32).  `workspace` holds
// [chunks, 2, c] f32; vec = 1 takes the 16-byte vector path (c % 8 == 0,
// 16-byte aligned x and dy).  Two launches on `stream`; returns the CUDA
// error of the first that fails, else 0.
extern "C" int hvd_bn_bwd_reduce(const void* x, const void* dy,
                                 const void* mean, const void* inv,
                                 void* workspace, void* dbeta, void* dgamma,
                                 int64_t n, int c, int chunks, int vec,
                                 int dtype, void* stream) {
  if (bad_shape(n, c, chunks, vec, x, dy, x)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hvd::kBF16)
    return vec ? launch_reduce<__nv_bfloat16, 8>(x, dy, mean, inv,
                                                 workspace, dbeta, dgamma,
                                                 n, c, chunks, s)
               : launch_reduce<__nv_bfloat16, 1>(x, dy, mean, inv,
                                                 workspace, dbeta, dgamma,
                                                 n, c, chunks, s);
  if (dtype == hvd::kF32)
    return vec ? launch_reduce<float, 8>(x, dy, mean, inv, workspace, dbeta,
                                         dgamma, n, c, chunks, s)
               : launch_reduce<float, 1>(x, dy, mean, inv, workspace, dbeta,
                                         dgamma, n, c, chunks, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 2: dx ([n, c], x's dtype) from x, dy, the [c] f32 rows mean, inv,
// scale and pass 1's dbeta, dgamma (local, or summed over the ranks), each
// sum divided by `count` (n, or the global row count; > 0).  One launch on
// `stream`.
extern "C" int hvd_bn_bwd_dx(const void* x, const void* dy, const void* mean,
                             const void* inv, const void* scale,
                             const void* dbeta, const void* dgamma, void* dx,
                             int64_t n, int c, int chunks, int vec, int dtype,
                             float count, void* stream) {
  if (bad_shape(n, c, chunks, vec, x, dy, dx) || !(count > 0.f))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hvd::kBF16)
    return vec ? launch_dx<__nv_bfloat16, 8>(x, dy, mean, inv, scale, dbeta,
                                             dgamma, dx, n, c, chunks, count,
                                             s)
               : launch_dx<__nv_bfloat16, 1>(x, dy, mean, inv, scale, dbeta,
                                             dgamma, dx, n, c, chunks, count,
                                             s);
  if (dtype == hvd::kF32)
    return vec ? launch_dx<float, 8>(x, dy, mean, inv, scale, dbeta, dgamma,
                                     dx, n, c, chunks, count, s)
               : launch_dx<float, 1>(x, dy, mean, inv, scale, dbeta, dgamma,
                                     dx, n, c, chunks, count, s);
  return (int)cudaErrorInvalidValue;
}
