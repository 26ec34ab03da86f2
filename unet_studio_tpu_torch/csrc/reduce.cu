// K2: the reductions of the JAX package's lane-reduce kernel
// (unet_studio_tpu/ops/packed.py:1292 _lane_reduce_kernel), in f32, in
// all of its modes:
// - per channel of a channels-last (N_vox, C) volume, moments_kernel:
//   "sum" (lane_sum) and "sqdiff" (lane_sqdiff, the sum of (x - mean)^2)
//   beside "sum_sq" (lane_sum_sq, sum and sum of squares in one read),
//   the instance norm's statistics: the deferred norm at inference where
//   no conv epilogue produced them (the decoder's dual conv), and every
//   norm of the training forward;
// - "norm_bwd" (norm_bwd_sums), norm_bwd_kernel: sum of g and of
//   g * (x - mean) * inv in one read of g and x, the two reductions of the
//   instance norm's backward;
// - "max" (lane_max), max_kernel: the largest value of a whole volume of
//   any size, from a zero-initialised accumulator as on the TPU, so the
//   result is max(0, max(x)).  The augmentation's fused image + label warp
//   scales the image by it (resample._pack_image_label).
//
// What bounds them on the H100: 1 to 5 operations per element read, so
// the bytes (each volume read once) bound them by far: in bf16 at the
// flagship's level 0, (192,224,192,16), sum_sq reads 264 MB (0.08 ms) and
// norm_bwd 528 MB (0.16 ms); the max of the flagship's f32 image reads
// 33 MB (0.01 ms).  The design streams the volumes with 16-byte loads in a
// grid-stride loop.  For the per-channel modes the stride is a multiple of
// C, so each thread keeps the same channels for its whole loop and holds
// their partial sums (and mean and inv) in registers; a block folds its
// threads' sums in shared memory and adds them to the (rows, C) output
// with atomics, so the order of the sum, and its last bits, change from
// run to run.  The max folds a block by shuffles and shared memory and
// takes one integer atomicMax per block (one per warp contended on the
// one address): for values >= 0 the order of the f32 bit patterns as
// integers is the order of the values, so the result is exact.

#include "common.cuh"

#define RED_THREADS 256
#define MAX_C 1024

template <typename T>
struct Vec;  // 16 bytes of T as f32
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

// Per-channel modes of moments_kernel (rows of its output)
#define RED_SUM 0     // out[0] = sum x
#define RED_SUM_SQ 1  // out[0] = sum x, out[1] = sum x^2
#define RED_SQDIFF 2  // out[0] = sum (x - mean)^2

// Needs C a power of two with Vec<T>::N <= C <= MAX_C, so that the grid
// stride (RED_THREADS * N elements times gridDim.x) is a multiple of C.
// mean: (C,) f32, read by RED_SQDIFF only.
template <typename T, int MODE>
__global__ void __launch_bounds__(RED_THREADS)
moments_kernel(const T* __restrict__ x, const float* __restrict__ mean, long n_vec, int c,
               float* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  constexpr int ROWS = MODE == RED_SUM_SQ ? 2 : 1;
  __shared__ float red[2][MAX_C];
  for (int i = threadIdx.x; i < ROWS * c; i += RED_THREADS) red[i / c][i % c] = 0.0f;

  const long first = (long)blockIdx.x * RED_THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * RED_THREADS;
  const int cbase = (int)((first * N) % c);
  float s[N], q[N], m[N], v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    s[k] = q[k] = 0.0f;
    m[k] = MODE == RED_SQDIFF ? mean[cbase + k] : 0.0f;
  }
  for (long i = first; i < n_vec; i += stride) {
    Vec<T>::load(x + i * N, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (MODE == RED_SQDIFF) {
        const float d = v[k] - m[k];
        s[k] = fmaf(d, d, s[k]);
      } else {
        s[k] += v[k];
        if (MODE == RED_SUM_SQ) q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }
  __syncthreads();  // red is zeroed
#pragma unroll
  for (int k = 0; k < N; ++k) {
    atomicAdd(&red[0][cbase + k], s[k]);
    if (ROWS == 2) atomicAdd(&red[1][cbase + k], q[k]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += RED_THREADS) {
    atomicAdd(&out[i], red[0][i]);
    if (ROWS == 2) atomicAdd(&out[c + i], red[1][i]);
  }
}

// *out = max(0, x[0..n)), out zeroed by the caller.  The first n_vec * N
// elements go as 16-byte vectors, the last (fewer than N) one by one.
// A block folds its warps in shared memory and takes one atomicMax.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
max_kernel(const T* __restrict__ x, long n_vec, long n, float* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  __shared__ float warp_max[RED_THREADS / 32];
  float m = 0.0f;  // the TPU kernel's zero-initialised accumulator
  float v[N];
  const long stride = (long)gridDim.x * RED_THREADS;
  for (long i = (long)blockIdx.x * RED_THREADS + threadIdx.x; i < n_vec; i += stride) {
    Vec<T>::load(x + i * N, v);
#pragma unroll
    for (int k = 0; k < N; ++k) m = fmaxf(m, v[k]);
  }
  if (blockIdx.x == 0)
    for (long i = n_vec * N + threadIdx.x; i < n; i += RED_THREADS) m = fmaxf(m, to_f(x[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < RED_THREADS / 32 ? warp_max[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(out), __float_as_int(m));
  }
}

// out[0][c] = sum g, out[1][c] = sum g * (x - mean[c]) * inv[c]; the same
// channel layout and stride rule as moments_kernel.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                const float* __restrict__ mean, const float* __restrict__ inv, long n_vec,
                int c, float* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[2][MAX_C];
  for (int i = threadIdx.x; i < 2 * c; i += RED_THREADS) red[i / c][i % c] = 0.0f;

  const long first = (long)blockIdx.x * RED_THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * RED_THREADS;
  const int cbase = (int)((first * N) % c);
  float s[N], q[N], m[N], iv[N], gv[N], xv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    s[k] = q[k] = 0.0f;
    m[k] = mean[cbase + k];
    iv[k] = inv[cbase + k];
  }
  for (long i = first; i < n_vec; i += stride) {
    Vec<T>::load(g + i * N, gv);
    Vec<T>::load(x + i * N, xv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[k] += gv[k];
      q[k] += gv[k] * (xv[k] - m[k]) * iv[k];
    }
  }
  __syncthreads();  // red is zeroed
#pragma unroll
  for (int k = 0; k < N; ++k) {
    atomicAdd(&red[0][cbase + k], s[k]);
    atomicAdd(&red[1][cbase + k], q[k]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += RED_THREADS) {
    atomicAdd(&out[i], red[0][i]);
    atomicAdd(&out[c + i], red[1][i]);
  }
}

static long reduce_blocks(long n_vec) {
  long blocks = (n_vec + RED_THREADS - 1) / RED_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : blocks;
}

template <int MODE>
static void launch_moments(const void* x, const void* mean, long n_vox, int c, void* out,
                           int dtype, cudaStream_t s) {
  const int n = dtype == DT_F32 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  const long n_vec = n_vox * c / n;
  const unsigned blocks = (unsigned)reduce_blocks(n_vec);
  if (dtype == DT_F32)
    moments_kernel<float, MODE><<<blocks, RED_THREADS, 0, s>>>(
        (const float*)x, (const float*)mean, n_vec, c, (float*)out);
  else
    moments_kernel<__nv_bfloat16, MODE><<<blocks, RED_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)mean, n_vec, c, (float*)out);
}

extern "C" {

// mode: RED_SUM, RED_SUM_SQ or RED_SQDIFF; mean: (C,) f32 for RED_SQDIFF,
// else unused; out: (rows, C) f32, zeroed by the caller.  Returns
// cudaGetLastError().
int unet_channel_moments(const void* x, const void* mean, long n_vox, int c, int mode,
                         void* out, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == RED_SUM)
    launch_moments<RED_SUM>(x, mean, n_vox, c, out, dtype, s);
  else if (mode == RED_SUM_SQ)
    launch_moments<RED_SUM_SQ>(x, mean, n_vox, c, out, dtype, s);
  else if (mode == RED_SQDIFF)
    launch_moments<RED_SQDIFF>(x, mean, n_vox, c, out, dtype, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: n values, 16-byte aligned; out: one f32, zeroed by the caller.
// Returns cudaGetLastError().
int unet_volume_max(const void* x, long n, void* out, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = dtype == DT_F32 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  const long n_vec = n / vec;
  // 4 blocks per SM keep the loads in flight; more only add atomics
  const long want = reduce_blocks(n_vec);
  const unsigned blocks = (unsigned)(want < 132 * 4 ? want : 132 * 4);
  if (dtype == DT_F32)
    max_kernel<float><<<blocks, RED_THREADS, 0, s>>>((const float*)x, n_vec, n, (float*)out);
  else
    max_kernel<__nv_bfloat16><<<blocks, RED_THREADS, 0, s>>>((const __nv_bfloat16*)x, n_vec,
                                                             n, (float*)out);
  return (int)cudaGetLastError();
}

// g, x: (n_vox, C) of one dtype; mean, inv: (C,) f32; out: (2, C) f32,
// zeroed by the caller.  Returns cudaGetLastError().
int unet_channel_norm_bwd(const void* g, const void* x, const void* mean, const void* inv,
                          long n_vox, int c, void* out, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = dtype == DT_F32 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  const long n_vec = n_vox * c / n;
  const long blocks = reduce_blocks(n_vec);
  if (dtype == DT_F32)
    norm_bwd_kernel<float><<<(unsigned)blocks, RED_THREADS, 0, s>>>(
        (const float*)g, (const float*)x, (const float*)mean, (const float*)inv, n_vec, c,
        (float*)out);
  else
    norm_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, RED_THREADS, 0, s>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)x, (const float*)mean,
        (const float*)inv, n_vec, c, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
