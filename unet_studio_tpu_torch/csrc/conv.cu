// Direct 3-D convolution kernels of the inference forward, channels-last
// (D, H, W, C), f32 accumulation.
//
// K1 conv3x3x3 stride 1 (replaces unet_studio_tpu/ops/pallas_conv.py:355
//    _fwd_kernel, and ops/packed.py:736 conv_entry, which reuses it for
//    Ci=1) and
// K3 conv3x3x3 stride 2 (replaces unet_studio_tpu/ops/packed.py:227
//    _s2_fwd_kernel) share one template, conv3_kernel, here in f32 only:
//    bf16 K1 and K3 run on the tensor cores (conv_tc.cu).  It takes:
//    - one input, or two inputs (skip and up of a decoder entry) whose
//      channels are the two halves of the weight's Ci, each with its own
//      prologue: that stands for the conv of their concatenation;
//    - an optional prologue per input, v = act(a[c] * x + b[c]) in f32
//      (multiply and add rounded apart, as the plain version does them),
//      applied on load.  Out-of-volume taps are skipped, so the padding
//      stays zero in the normalized domain;
//    - an optional stats epilogue: per-channel sum and sum of squares of
//      the f32 accumulator (bias included), folded over each warp's lanes
//      with shuffles, then over the warps in warp order; the block writes
//      its (2, 16) slice of one row of a (blocks, 2, Co) partial buffer
//      and unet_dw_reduce (conv_bwd.cu) adds the rows in order: no
//      atomics, the same bits from run to run.
// K4 conv_trans2x (replaces unet_studio_tpu/ops/packed.py:439
//    _trans_kernel): ks2/stride-2 transposed conv; output voxel o reads
//    input voxel o/2 with weight parity o%2, so there is no halo and no
//    padding; here in f32 only: bf16 K4 runs on the tensor cores
//    (trans_tc.cu).
//
// What bounds them on the H100 (bf16, one input read and one output
// written): a C->C conv does 2*27*C*C operations per 4*C bytes of voxel
// traffic, 216 op/byte at C=16 (under the ~295 op/byte ridge: bytes bound
// it), 432 at C=32 and 864 at C=64 (the tensor-core rate bounds them).
// At the flagship's level 0, (192,224,192,16), K1 moves 528 MB and does
// 114 GFLOP: 0.16 ms at 3.35 TB/s against 0.12 ms at the bf16 tensor-core
// peak.  K3 16->32 there moves 330 MB (0.10 ms); K4 32->16 into level 0
// moves 330 MB for 8.5 GFLOP (0.10 ms).
// These kernels run on the CUDA cores in f32 FMA, whose 67 TFLOP/s put
// level-0 K1 at 1.7 ms at best: one output voxel and 16 output channels
// per thread, the weights of a 16-channel input chunk staged in shared
// memory and read as broadcasts, each voxel's channel run read with
// 16-byte loads.  They serve f32, where the tensor cores would mean TF32
// (the exact oracle of the bf16 kernels).

#include "common.cuh"

#define THREADS 128
#define CO_T 16  // output channels per thread (and per grid.y slice)
#define CI_T 16  // input channels staged in shared memory per chunk

template <typename T, int STRIDE>
__global__ void __launch_bounds__(THREADS)
conv3_kernel(const T* __restrict__ xa, const float* __restrict__ pa_a,
             const float* __restrict__ pb_a, int act_a, const T* __restrict__ xb,
             const float* __restrict__ pa_b, const float* __restrict__ pb_b,
             int act_b, int ci, const T* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ y,
             float* __restrict__ part, int D, int H, int W, int co) {
  __shared__ float ws[27][CI_T][CO_T];
  __shared__ float pro_a[CI_T];
  __shared__ float pro_b[CI_T];
  __shared__ float red[THREADS / 32][2][CO_T];

  const int OD = D / STRIDE, OH = H / STRIDE, OW = W / STRIDE;
  const long n_out = (long)OD * OH * OW;
  const long vox = (long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = vox < n_out;
  const int co0 = blockIdx.y * CO_T;
  int ox = 0, oy = 0, oz = 0;
  if (valid) {
    ox = (int)(vox % OW);
    oy = (int)((vox / OW) % OH);
    oz = (int)(vox / ((long)OW * OH));
  }

  float acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = bias[co0 + j];

  const int n_src = xb != nullptr ? 2 : 1;
  const int ci_total = ci * n_src;
  for (int src = 0; src < n_src; ++src) {
    const T* x = src ? xb : xa;
    const float* pa = src ? pa_b : pa_a;
    const float* pb = src ? pb_b : pb_a;
    const int act = src ? act_b : act_a;
    for (int c0 = 0; c0 < ci; c0 += CI_T) {
      const int nc = min(CI_T, ci - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < 27 * CI_T * CO_T; i += THREADS) {
        const int j = i % CO_T, c = (i / CO_T) % CI_T, tap = i / (CO_T * CI_T);
        ws[tap][c][j] =
            c < nc ? to_f(w[((long)tap * ci_total + src * ci + c0 + c) * co + co0 + j]) : 0.0f;
      }
      if (threadIdx.x < CI_T) {
        const bool live = pa != nullptr && threadIdx.x < nc;
        pro_a[threadIdx.x] = live ? pa[c0 + threadIdx.x] : 1.0f;
        pro_b[threadIdx.x] = live ? pb[c0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      if (!valid) continue;
#pragma unroll 1
      for (int tap = 0; tap < 27; ++tap) {
        const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
        const int iz = oz * STRIDE + dz - 1, iy = oy * STRIDE + dy - 1, ix = ox * STRIDE + dx - 1;
        if (iz < 0 || iz >= D || iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
        const T* p = x + (((long)iz * H + iy) * W + ix) * ci + c0;
        float v[CI_T];
        if (nc == CI_T) {
          load16(p, v);
        } else {
#pragma unroll
          for (int c = 0; c < CI_T; ++c) v[c] = c < nc ? to_f(p[c]) : 0.0f;
        }
        if (pa != nullptr) {
#pragma unroll
          for (int c = 0; c < CI_T; ++c)
            v[c] = to_f(from_f<T>(apply_act(__fadd_rn(__fmul_rn(v[c], pro_a[c]), pro_b[c]), act)));
        }
        const float* wt = &ws[tap][0][0];
#pragma unroll
        for (int c = 0; c < CI_T; ++c) {
          if (c < nc) {
#pragma unroll
            for (int j = 0; j < CO_T; ++j) acc[j] = fmaf(v[c], wt[c * CO_T + j], acc[j]);
          }
        }
      }
    }
  }

  if (part != nullptr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) {
      float s = valid ? acc[j] : 0.0f;
      float q = s * s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
        q += __shfl_down_sync(0xffffffffu, q, off);
      }
      if (lane == 0) {
        red[warp][0][j] = s;
        red[warp][1][j] = q;
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * CO_T) {
      const int r = threadIdx.x / CO_T, j = threadIdx.x % CO_T;
      float t = red[0][r][j];
#pragma unroll
      for (int w = 1; w < THREADS / 32; ++w) t += red[w][r][j];
      part[((long)blockIdx.x * 2 + r) * co + co0 + j] = t;
    }
  }
  if (valid) store16(y + vox * co + co0, acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
trans2x_kernel(const T* __restrict__ x, const float* __restrict__ pa,
               const float* __restrict__ pb, int act, int ci,
               const T* __restrict__ w, const float* __restrict__ bias,
               T* __restrict__ y, int D, int H, int W, int co) {
  __shared__ float ws[8][CI_T][CO_T];
  __shared__ float pro_a[CI_T];
  __shared__ float pro_b[CI_T];

  const int OD = 2 * D, OH = 2 * H, OW = 2 * W;
  const long n_out = (long)OD * OH * OW;
  const long vox = (long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = vox < n_out;
  const int co0 = blockIdx.y * CO_T;
  int ox = 0, oy = 0, oz = 0;
  if (valid) {
    ox = (int)(vox % OW);
    oy = (int)((vox / OW) % OH);
    oz = (int)(vox / ((long)OW * OH));
  }
  const int parity = ((oz & 1) * 2 + (oy & 1)) * 2 + (ox & 1);
  const long src_vox = ((long)(oz >> 1) * H + (oy >> 1)) * W + (ox >> 1);

  float acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = bias[co0 + j];

  for (int c0 = 0; c0 < ci; c0 += CI_T) {
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * CI_T * CO_T; i += THREADS) {
      const int j = i % CO_T, c = (i / CO_T) % CI_T, p = i / (CO_T * CI_T);
      ws[p][c][j] = to_f(w[((long)p * ci + c0 + c) * co + co0 + j]);
    }
    if (threadIdx.x < CI_T) {
      pro_a[threadIdx.x] = pa != nullptr ? pa[c0 + threadIdx.x] : 1.0f;
      pro_b[threadIdx.x] = pa != nullptr ? pb[c0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    if (!valid) continue;
    float v[CI_T];
    load16(x + src_vox * ci + c0, v);
    if (pa != nullptr) {
#pragma unroll
      for (int c = 0; c < CI_T; ++c)
        v[c] = to_f(from_f<T>(apply_act(__fadd_rn(__fmul_rn(v[c], pro_a[c]), pro_b[c]), act)));
    }
    const float* wt = &ws[parity][0][0];
#pragma unroll
    for (int c = 0; c < CI_T; ++c) {
#pragma unroll
      for (int j = 0; j < CO_T; ++j) acc[j] = fmaf(v[c], wt[c * CO_T + j], acc[j]);
    }
  }
  if (valid) store16(y + vox * co + co0, acc);
}

extern "C" int unet_dw_reduce(const void* part, int nblk, long n, void* out, void* stream);

extern "C" {

// Rows of the stats partial buffer of unet_conv3 (its grid along x).
int unet_conv3_rows(int D, int H, int W, int stride) {
  const long n_out = (long)(D / stride) * (H / stride) * (W / stride);
  return (int)((n_out + THREADS - 1) / THREADS);
}

// f32 only (bf16 is conv_tc.cu's).  Returns cudaGetLastError() after the
// launches (0 on success).  The Python wrapper (ops/conv.py) has checked
// shape, contiguity, alignment and that co is a multiple of 16.  part:
// (unet_conv3_rows, 2, co) f32 scratch and stats: (2, co) f32, both null
// without stats; a second launch adds part's rows in order into stats.
int unet_conv3(const void* xa, const void* pa_a, const void* pb_a, int act_a, const void* xb,
               const void* pa_b, const void* pb_b, int act_b, int ci, const void* w,
               const void* bias, void* y, void* part, void* stats, int D, int H, int W, int co,
               int stride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = unet_conv3_rows(D, H, W, stride);
  const dim3 grid((unsigned)rows, co / CO_T);
#define CONV3_LAUNCH(S)                                                                       \
  conv3_kernel<float, S><<<grid, THREADS, 0, s>>>(                                            \
      (const float*)xa, (const float*)pa_a, (const float*)pb_a, act_a, (const float*)xb,       \
      (const float*)pa_b, (const float*)pb_b, act_b, ci, (const float*)w, (const float*)bias, \
      (float*)y, (float*)part, D, H, W, co)
  if (stride == 1)
    CONV3_LAUNCH(1);
  else
    CONV3_LAUNCH(2);
#undef CONV3_LAUNCH
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || part == nullptr) return rc;
  return unet_dw_reduce(part, rows, 2L * co, stats, stream);
}

// f32 only (bf16 is trans_tc.cu's): x (D, H, W, ci), w (8, ci, co)
// parity-major, y (2D, 2H, 2W, co)
int unet_trans2x(const void* x, const void* pa, const void* pb, int act, int ci, const void* w,
                 const void* bias, void* y, int D, int H, int W, int co, void* stream) {
  const long n_out = 8L * D * H * W;
  const dim3 grid((unsigned)((n_out + THREADS - 1) / THREADS), co / CO_T);
  trans2x_kernel<float><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)pa, (const float*)pb, act, ci, (const float*)w,
      (const float*)bias, (float*)y, D, H, W, co);
  return (int)cudaGetLastError();
}

}  // extern "C"
