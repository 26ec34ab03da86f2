// K2: per-channel reductions of a channels-last (N_vox, C) volume, in f32.
// Replaces unet_studio_tpu/ops/packed.py:1292 _lane_reduce_kernel in two
// of its modes:
// - "sum_sq" (lane_sum_sq), channel_sum_sq: sum and sum of squares in one
//   read.  It gives the instance norm its statistics: the deferred norm
//   at inference where no conv epilogue produced them (the decoder's dual
//   conv), and every norm of the training forward.
// - "norm_bwd" (norm_bwd_sums), channel_norm_bwd: sum of g and of
//   g * (x - mean) * inv in one read of g and x, the two reductions of the
//   instance norm's backward.
//
// What bounds them on the H100: 3 (sum_sq) or 5 (norm_bwd) operations per
// element read, so the bytes (each volume read once) bound them by far: in
// bf16 at the flagship's level 0, (192,224,192,16), sum_sq reads 264 MB
// (0.08 ms) and norm_bwd 528 MB (0.16 ms).  The design streams the volumes
// with 16-byte loads in a grid-stride loop.  The stride is a multiple of
// C, so each thread keeps the same channels for its whole loop and holds
// their partial sums (and, for norm_bwd, their mean and inv) in registers;
// a block folds its threads' sums in shared memory and adds them to the
// (2, C) output with atomics, so the order of the sum, and its last bits,
// change from run to run.

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

// Needs C a power of two with Vec<T>::N <= C <= MAX_C, so that the grid
// stride (RED_THREADS * N elements times gridDim.x) is a multiple of C.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
sum_sq_kernel(const T* __restrict__ x, long n_vec, int c, float* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[2][MAX_C];
  for (int i = threadIdx.x; i < 2 * c; i += RED_THREADS) red[i / c][i % c] = 0.0f;

  float s[N], q[N], v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = q[k] = 0.0f;
  const long first = (long)blockIdx.x * RED_THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * RED_THREADS;
  for (long i = first; i < n_vec; i += stride) {
    Vec<T>::load(x + i * N, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[k] += v[k];
      q[k] = fmaf(v[k], v[k], q[k]);
    }
  }
  __syncthreads();  // red is zeroed
  const int cbase = (int)((first * N) % c);
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

// out[0][c] = sum g, out[1][c] = sum g * (x - mean[c]) * inv[c]; the same
// channel layout and stride rule as sum_sq_kernel.
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

extern "C" {

// out: (2, C) f32, zeroed by the caller.  Returns cudaGetLastError().
int unet_channel_sum_sq(const void* x, long n_vox, int c, void* out, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = dtype == DT_F32 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  const long n_vec = n_vox * c / n;
  const long blocks = reduce_blocks(n_vec);
  if (dtype == DT_F32)
    sum_sq_kernel<float><<<(unsigned)blocks, RED_THREADS, 0, s>>>((const float*)x, n_vec, c,
                                                                  (float*)out);
  else
    sum_sq_kernel<__nv_bfloat16><<<(unsigned)blocks, RED_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, n_vec, c, (float*)out);
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
