// K2: the reductions of the JAX package's lane-reduce kernel
// (unet_studio_tpu/ops/packed.py:1292 _lane_reduce_kernel), in f32, in
// all of its modes:
// - per channel of a channels-last (N_vox, C) volume, channel_reduce_kernel:
//   "sum" (lane_sum) and "sqdiff" (lane_sqdiff, the sum of (x - mean)^2)
//   beside "sum_sq" (lane_sum_sq, sum and sum of squares in one read),
//   the instance norm's statistics: the deferred norm at inference where
//   no conv epilogue produced them (the decoder's dual conv), and every
//   norm of the training forward; and "norm_bwd" (norm_bwd_sums): sum of
//   g and of g * (x - mean) * inv in one read of g and x, the two
//   reductions of the instance norm's backward; and "norm_act_bwd"
//   (norm_act_bwd_sums): the same two sums of g' = where(y >= 0, g,
//   g * 0.01), the gradient through the leaky ReLU that follows the
//   training norm, y recomputed from x (norm_act_y), so g' is never
//   written;
// - "max" (lane_max), max_kernel: the largest value of a whole volume of
//   any size, from a zero-initialised accumulator as on the TPU, so the
//   result is max(0, max(x)).  The augmentation's fused image + label warp
//   scales the image by it (resample._pack_image_label).
//
// What bounds them on the H100: 1 to 5 operations per element read, so
// the bytes (each volume read once) bound them by far: in bf16 at the
// flagship's level 0, (192,224,192,16), sum_sq reads 264 MB (0.08 ms) and
// norm_bwd 528 MB (0.16 ms); the max of the flagship's f32 image reads
// 33 MB (0.01 ms).
//
// Design, the same for every mode:
// - One wave of blocks (RED_THREADS threads, as many blocks as fit on the
//   card at once, at most RED_MAX_BLOCKS), each thread walking the volume
//   with RED_UNROLL independent 16-byte loads in flight per step, the
//   tail masked.  For the per-channel modes the grid stride is a multiple
//   of C, so a thread keeps the same N channels (N = 16 bytes of T) for
//   its whole walk and holds their sums (and mean and inv) in registers.
// - The block's fold, in a fixed order and without atomics: an xor-shuffle
//   fold over the lanes that hold the same channels (offsets >= C/N),
//   then one shared row per warp (per group of lanes when C/N > 32),
//   added across warps in warp order; the block writes its (rows, C)
//   partial to a scratch buffer the wrapper passes (never zeroed).
// - The last block to finish (a ticket counter that atomicInc wraps back
//   to 0, so it needs no reset between launches) adds the partials in
//   block order into out: out needs no zeroing, one launch does all, and
//   the result is bitwise the same from run to run for a given shape.
//   The ticket and the partials belong to the launch's (device, stream):
//   the wrapper (ops/reduce.py) passes both, so launches on two streams
//   may overlap, and launches on one stream run in order.
// The max folds the same way with fmaxf, which is exact in any order.
//
// Beside K2, the training norm + leaky ReLU's two elementwise passes
// (ops/norm.py InstanceNormActTrain; they replace no TPU kernel: the JAX
// package leaves them to XLA, which fuses them): norm_act_kernel, the
// forward, reads x and writes y = act(x * a + b); norm_act_dx_kernel, the
// backward's apply, reads g and x and writes dx.  Both are bound by bytes
// (a few operations per element): at nnU-Net's level 0, (192,224,192,32)
// bf16, 528 MB a volume, the forward moves 1.06 GB (0.32 ms), norm_act_bwd
// as much, and the apply 1.59 GB (0.47 ms).  They walk the volume as K2
// does (one wave, the grid stride a multiple of C, so a thread's channels
// and their (C,) constants stay in registers), and they round as the
// PyTorch composition they replace does: each bf16 op computed in f32 and
// rounded to T, __fmul_rn / __fadd_rn / __fsub_rn so that nvcc contracts
// nothing across a rounding.  Their results, and norm_act_bwd's sums, are
// bitwise those of the composition.

#include "common.cuh"

#define RED_THREADS 512
#define RED_UNROLL 4
#define RED_MAX_BLOCKS 1024  // ops/reduce.py sizes the partial buffer by it

// Per-channel modes of channel_reduce_kernel (rows of its output)
#define RED_SUM 0       // out[0] = sum x
#define RED_SUM_SQ 1    // out[0] = sum x, out[1] = sum x^2
#define RED_SQDIFF 2    // out[0] = sum (x - mean)^2
#define RED_NORM_BWD 3  // out[0] = sum g, out[1] = sum g * (x - mean) * inv
#define RED_NORM_ACT_BWD 4  // RED_NORM_BWD of g' = leaky_grad(g, norm_act_y(x))

// 16 bytes of T: loaded raw, converted to f32 where they are used
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void to_f32(const Raw& v, float* out) {
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void to_f32(const Raw& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// The training norm + activation as ops/norm.py computes it, one rounding
// per PyTorch op.  round_to<T>: a value rounded to T (nearest even), back
// in f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// The affine of channel ch (_apply): a = T(inv * scale) (also the
// backward's coef), b = T(bias - mean * inv * scale), in f32.
template <typename T>
__device__ __forceinline__ void norm_affine(const float* mean, const float* inv,
                                            const float* scale, const float* bias, int ch,
                                            float& a, float& b) {
  const float s = scale[ch], iv = inv[ch];
  a = round_to<T>(__fmul_rn(iv, s));
  b = round_to<T>(__fsub_rn(bias[ch], __fmul_rn(__fmul_rn(mean[ch], iv), s)));
}

// y = x * a + b (two ops of T), then F.leaky_relu's y > 0 ? y : y * 0.01
template <typename T, bool LEAKY>
__device__ __forceinline__ float norm_act_y(float x, float a, float b) {
  const float z = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x, a)), b));
  if (!LEAKY) return z;
  return z > 0.0f ? z : round_to<T>(__fmul_rn(z, 0.01f));
}

// the leaky ReLU's input gradient (ops/conv.py _LeakyReLU.backward):
// where(y >= 0, g, g * 0.01)
template <typename T>
__device__ __forceinline__ float leaky_grad(float g, float y) {
  return y >= 0.0f ? g : round_to<T>(__fmul_rn(g, 0.01f));
}

// Every thread: after its partial stores, is this block the launch's last?
// ticket: blocks done in the running launch on this stream (0 between
// launches).
__device__ __forceinline__ bool last_block_done(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();  // this thread's partial is visible to the other blocks
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block: out[i] = sum over blocks b, in order, of part[b][i], for
// n_out values; several threads per value when n_out < RED_THREADS, each
// taking a fixed, strided set of blocks, then added in thread order.
__device__ void fold_partials(const float* part, int nblk, int n_out, float* sh,
                              float* __restrict__ out) {
  const int tid = threadIdx.x;
  if (n_out >= RED_THREADS) {
    for (int i = tid; i < n_out; i += RED_THREADS) {
      float s = 0.0f;
      for (int b = 0; b < nblk; ++b) s += __ldcg(part + (long)b * n_out + i);
      out[i] = s;
    }
    return;
  }
  const int per = RED_THREADS / n_out, i = tid % n_out, sub = tid / n_out;
  float s = 0.0f;
  if (sub < per)
    for (int b = sub; b < nblk; b += per) s += __ldcg(part + (long)b * n_out + i);
  sh[tid] = s;
  __syncthreads();
  if (tid < n_out) {
    float t = 0.0f;
    for (int j = 0; j < per; ++j) t += sh[j * n_out + tid];
    out[tid] = t;
  }
}

// Shared floats channel_reduce_kernel needs for ROWS rows at C channels.
static int reduce_smem_floats(int rows, int c, int n) {
  const int p = c / n, s = p > 32 ? p : 32;
  const int fold = rows * (RED_THREADS / s) * c;
  return fold > RED_THREADS ? fold : RED_THREADS;
}

// Needs C a power of two with Vec<T>::N <= C <= 1024, so that the grid
// stride (RED_THREADS * N elements times gridDim.x) is a multiple of C.
// a: the volume (g for RED_NORM_BWD and RED_NORM_ACT_BWD); b: x for
// those two, else unused; mean: (C,) f32 for RED_SQDIFF and the two; inv,
// and for RED_NORM_ACT_BWD scale and bias: (C,) f32; part: (gridDim.x,
// rows, C) scratch; ticket: the stream's ticket; out: (rows, C).
template <typename T, int MODE>
__global__ void __launch_bounds__(RED_THREADS)
channel_reduce_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ mean, const float* __restrict__ inv,
                      const float* __restrict__ scale, const float* __restrict__ bias, long n_vec,
                      int c, float* __restrict__ part, unsigned int* ticket,
                      float* __restrict__ out) {
  using V = Vec<T>;
  constexpr int N = V::N;
  constexpr bool ACT = MODE == RED_NORM_ACT_BWD;
  constexpr bool TWO = MODE == RED_NORM_BWD || ACT;
  constexpr int ROWS = (MODE == RED_SUM_SQ || TWO) ? 2 : 1;
  extern __shared__ float sh[];

  const int tid = threadIdx.x;
  const int cbase = (tid * N) % c;  // the block's stride is a multiple of C
  float v[ROWS][N], m[N], iv[N], na[N], nb[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r][k] = 0.0f;
    m[k] = (MODE == RED_SQDIFF || TWO) ? mean[cbase + k] : 0.0f;
    iv[k] = TWO ? inv[cbase + k] : 0.0f;
    if (ACT) norm_affine<T>(mean, inv, scale, bias, cbase + k, na[k], nb[k]);
  }
  const long stride = (long)gridDim.x * RED_THREADS;
  for (long i0 = (long)blockIdx.x * RED_THREADS + tid; i0 < n_vec; i0 += RED_UNROLL * stride) {
    typename V::Raw ra[RED_UNROLL], rb[RED_UNROLL];
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      const long i = i0 + u * stride;
      if (i < n_vec) {
        ra[u] = V::load(a + i * N);
        if (TWO) rb[u] = V::load(b + i * N);
      }
    }
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      if (i0 + u * stride >= n_vec) break;  // the tail of the walk
      float fa[N], fb[N];
      V::to_f32(ra[u], fa);
      if (TWO) V::to_f32(rb[u], fb);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (ACT) fa[k] = leaky_grad<T>(fa[k], norm_act_y<T, true>(fb[k], na[k], nb[k]));
        if (MODE == RED_SQDIFF) {
          const float d = fa[k] - m[k];
          v[0][k] = fmaf(d, d, v[0][k]);
        } else if (TWO) {
          v[0][k] += fa[k];
          v[1][k] += fa[k] * (fb[k] - m[k]) * iv[k];
        } else {
          v[0][k] += fa[k];
          if (MODE == RED_SUM_SQ) v[1][k] = fmaf(fa[k], fa[k], v[1][k]);
        }
      }
    }
  }

  // lanes l and l' hold the same channels when l = l' (mod C/N)
  const int p = c / N;
  for (int off = p; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int k = 0; k < N; ++k) v[r][k] += __shfl_xor_sync(0xffffffffu, v[r][k], off);
  // one representative per group of lanes: R rows of C per output row
  const int s = p > 32 ? p : 32, nrep = RED_THREADS / s;
  if (tid % s < p) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int k = 0; k < N; ++k) sh[(r * nrep + tid / s) * c + cbase + k] = v[r][k];
  }
  __syncthreads();
  float* bpart = part + (long)blockIdx.x * ROWS * c;
  for (int i = tid; i < ROWS * c; i += RED_THREADS) {
    const int r = i / c, ch = i % c;
    float t = 0.0f;
    for (int j = 0; j < nrep; ++j) t += sh[(r * nrep + j) * c + ch];
    bpart[i] = t;
  }
  if (!last_block_done(ticket)) return;
  fold_partials(part, gridDim.x, ROWS * c, sh, out);
}

// *out = max(0, x[0..n)).  The first n_vec * N elements go as 16-byte
// vectors, the last (fewer than N) one by one; part: (gridDim.x,) scratch;
// ticket: the stream's ticket.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
max_kernel(const T* __restrict__ x, long n_vec, long n, float* __restrict__ part,
           unsigned int* ticket, float* __restrict__ out) {
  using V = Vec<T>;
  constexpr int N = V::N;
  __shared__ float warp_max[RED_THREADS / 32];
  float m = 0.0f;  // the TPU kernel's zero-initialised accumulator
  const long stride = (long)gridDim.x * RED_THREADS;
  for (long i0 = (long)blockIdx.x * RED_THREADS + threadIdx.x; i0 < n_vec;
       i0 += RED_UNROLL * stride) {
    typename V::Raw raw[RED_UNROLL];
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u)
      if (i0 + u * stride < n_vec) raw[u] = V::load(x + (i0 + u * stride) * N);
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      if (i0 + u * stride >= n_vec) break;
      float f[N];
      V::to_f32(raw[u], f);
#pragma unroll
      for (int k = 0; k < N; ++k) m = fmaxf(m, f[k]);
    }
  }
  if (blockIdx.x == 0)
    for (long i = n_vec * N + threadIdx.x; i < n; i += RED_THREADS) m = fmaxf(m, to_f(x[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < RED_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    part[blockIdx.x] = m;
  }
  if (!last_block_done(ticket)) return;
  if (threadIdx.x < 32) {
    m = 0.0f;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) m = fmaxf(m, __ldcg(part + b));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) *out = m;
  }
}

// y = norm_act_y(x) for a channels-last (n_vec * N / C, C) volume (the
// training norm's forward after K2's statistics).  mean, inv, scale, bias:
// (C,) f32.  C as channel_reduce_kernel needs it.
template <typename T, bool LEAKY>
__global__ void __launch_bounds__(RED_THREADS)
norm_act_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ inv, const float* __restrict__ scale,
                const float* __restrict__ bias, long n_vec, int c, T* __restrict__ y) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int cbase = (threadIdx.x * N) % c;
  float na[N], nb[N];
#pragma unroll
  for (int k = 0; k < N; ++k) norm_affine<T>(mean, inv, scale, bias, cbase + k, na[k], nb[k]);
  const long stride = (long)gridDim.x * RED_THREADS;
  for (long i0 = (long)blockIdx.x * RED_THREADS + threadIdx.x; i0 < n_vec;
       i0 += RED_UNROLL * stride) {
    typename V::Raw raw[RED_UNROLL];
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u)
      if (i0 + u * stride < n_vec) raw[u] = V::load(x + (i0 + u * stride) * N);
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      if (i0 + u * stride >= n_vec) break;
      float f[N];
      V::to_f32(raw[u], f);
#pragma unroll
      for (int k = 0; k < N; ++k) f[k] = norm_act_y<T, LEAKY>(f[k], na[k], nb[k]);
      V::store(y + (i0 + u * stride) * N, f);
    }
  }
}

// The norm's input gradient (ops/norm.py norm_act_dx_plain) from g, the
// gradient of y = norm_act_y(x): g' = leaky_grad(g, y) when LEAKY, else g;
// xhat = T(T(x - T(mean)) * T(inv)); dx = T(a * T(T(g' - T(g_mean)) -
// T(xhat * T(gx_mean)))), a = T(inv * scale).  means: (2, C) f32, the
// rows g_mean and gx_mean.
template <typename T, bool LEAKY>
__global__ void __launch_bounds__(RED_THREADS)
norm_act_dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const float* __restrict__ mean, const float* __restrict__ inv,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ means, long n_vec, int c, T* __restrict__ dx) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int cbase = (threadIdx.x * N) % c;
  float na[N], nb[N], m[N], iv[N], gm[N], gxm[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int ch = cbase + k;
    norm_affine<T>(mean, inv, scale, bias, ch, na[k], nb[k]);
    m[k] = round_to<T>(mean[ch]);
    iv[k] = round_to<T>(inv[ch]);
    gm[k] = round_to<T>(means[ch]);
    gxm[k] = round_to<T>(means[c + ch]);
  }
  const long stride = (long)gridDim.x * RED_THREADS;
  for (long i0 = (long)blockIdx.x * RED_THREADS + threadIdx.x; i0 < n_vec;
       i0 += RED_UNROLL * stride) {
    typename V::Raw rg[RED_UNROLL], rx[RED_UNROLL];
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      const long i = i0 + u * stride;
      if (i < n_vec) {
        rg[u] = V::load(g + i * N);
        rx[u] = V::load(x + i * N);
      }
    }
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      if (i0 + u * stride >= n_vec) break;
      float fg[N], fx[N];
      V::to_f32(rg[u], fg);
      V::to_f32(rx[u], fx);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float gp =
            LEAKY ? leaky_grad<T>(fg[k], norm_act_y<T, true>(fx[k], na[k], nb[k])) : fg[k];
        const float xhat = round_to<T>(__fmul_rn(round_to<T>(__fsub_rn(fx[k], m[k])), iv[k]));
        const float t = round_to<T>(__fsub_rn(round_to<T>(__fsub_rn(gp, gm[k])),
                                              round_to<T>(__fmul_rn(xhat, gxm[k]))));
        fg[k] = round_to<T>(__fmul_rn(na[k], t));
      }
      V::store(dx + (i0 + u * stride) * N, fg);
    }
  }
}

static int red_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Blocks of `kernel` that fit on one SM with `smem` bytes of dynamic shared
// memory, asked of the runtime once per (kernel, smem): the query costs
// host time on every launch otherwise.
static int blocks_per_sm(const void* kernel, int smem) {
  static const void* keys[32];
  static int smems[32], vals[32], n = 0;
  for (int i = 0; i < n; ++i)
    if (keys[i] == kernel && smems[i] == smem) return vals[i];
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RED_THREADS, smem);
  if (per_sm < 1) per_sm = 1;
  if (n < 32) {
    keys[n] = kernel;
    smems[n] = smem;
    vals[n++] = per_sm;
  }
  return per_sm;
}

// One wave: as many blocks as fit on the card at once, no more than the
// work needs and no more than RED_MAX_BLOCKS.
static unsigned reduce_grid(const void* kernel, int smem, long n_vec) {
  long blocks = (long)blocks_per_sm(kernel, smem) * red_sm_count();
  const long need = (n_vec + RED_THREADS - 1) / RED_THREADS;
  if (blocks > need) blocks = need;
  if (blocks > RED_MAX_BLOCKS) blocks = RED_MAX_BLOCKS;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// The (C,) f32 vectors of the norm's channels, as the kernels take them.
struct NormVecs {
  const float *mean, *inv, *scale, *bias;
};

template <typename T, int MODE>
static void launch_channels(const void* a, const void* b, NormVecs nv, long n_vox, int c,
                            void* part, void* ticket, void* out, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  constexpr int ROWS = (MODE == RED_SUM_SQ || MODE >= RED_NORM_BWD) ? 2 : 1;
  const long n_vec = n_vox * c / N;
  const int smem = reduce_smem_floats(ROWS, c, N) * (int)sizeof(float);
  auto kernel = channel_reduce_kernel<T, MODE>;
  const unsigned grid = reduce_grid((const void*)kernel, smem, n_vec);
  kernel<<<grid, RED_THREADS, smem, s>>>((const T*)a, (const T*)b, nv.mean, nv.inv, nv.scale,
                                         nv.bias, n_vec, c, (float*)part,
                                         (unsigned int*)ticket, (float*)out);
}

template <int MODE>
static void launch_mode(const void* a, const void* b, NormVecs nv, long n_vox, int c,
                        void* part, void* ticket, void* out, int dtype, cudaStream_t s) {
  if (dtype == DT_F32)
    launch_channels<float, MODE>(a, b, nv, n_vox, c, part, ticket, out, s);
  else
    launch_channels<__nv_bfloat16, MODE>(a, b, nv, n_vox, c, part, ticket, out, s);
}

template <typename T, bool LEAKY>
static void launch_norm_act(const void* x, NormVecs nv, long n_vox, int c, void* y,
                            cudaStream_t s) {
  const long n_vec = n_vox * c / Vec<T>::N;
  auto kernel = norm_act_kernel<T, LEAKY>;
  kernel<<<reduce_grid((const void*)kernel, 0, n_vec), RED_THREADS, 0, s>>>(
      (const T*)x, nv.mean, nv.inv, nv.scale, nv.bias, n_vec, c, (T*)y);
}

template <typename T, bool LEAKY>
static void launch_norm_act_dx(const void* g, const void* x, NormVecs nv, const void* means,
                               long n_vox, int c, void* dx, cudaStream_t s) {
  const long n_vec = n_vox * c / Vec<T>::N;
  auto kernel = norm_act_dx_kernel<T, LEAKY>;
  kernel<<<reduce_grid((const void*)kernel, 0, n_vec), RED_THREADS, 0, s>>>(
      (const T*)g, (const T*)x, nv.mean, nv.inv, nv.scale, nv.bias, (const float*)means, n_vec,
      c, (T*)dx);
}

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 on success).
// The wrappers (ops/reduce.py, ops/norm.py) have checked dtype,
// contiguity, 16-byte alignment and C.  part: RED_MAX_BLOCKS * rows * C f32
// scratch (rows: 1 for RED_SUM and RED_SQDIFF, else 2), its contents
// unused; ticket:
// one unsigned int, 0 at allocation, never touched between launches; both
// belong to the launch's stream.  out: (rows, C) f32, uninitialised.

// mode: RED_SUM, RED_SUM_SQ or RED_SQDIFF; mean: (C,) f32 for RED_SQDIFF,
// else unused.
int unet_channel_moments(const void* x, const void* mean, long n_vox, int c, int mode,
                         void* part, void* ticket, void* out, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const NormVecs nv = {(const float*)mean, nullptr, nullptr, nullptr};
  if (mode == RED_SUM)
    launch_mode<RED_SUM>(x, nullptr, nv, n_vox, c, part, ticket, out, dtype, s);
  else if (mode == RED_SUM_SQ)
    launch_mode<RED_SUM_SQ>(x, nullptr, nv, n_vox, c, part, ticket, out, dtype, s);
  else if (mode == RED_SQDIFF)
    launch_mode<RED_SQDIFF>(x, nullptr, nv, n_vox, c, part, ticket, out, dtype, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g, x: (n_vox, C) of one dtype; mean, inv: (C,) f32; out: (2, C).
int unet_channel_norm_bwd(const void* g, const void* x, const void* mean, const void* inv,
                          long n_vox, int c, void* part, void* ticket, void* out, int dtype,
                          void* stream) {
  const NormVecs nv = {(const float*)mean, (const float*)inv, nullptr, nullptr};
  launch_mode<RED_NORM_BWD>(g, x, nv, n_vox, c, part, ticket, out, dtype, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// RED_NORM_ACT_BWD: as unet_channel_norm_bwd, with scale, bias: (C,) f32.
int unet_channel_norm_act_bwd(const void* g, const void* x, const void* mean, const void* inv,
                              const void* scale, const void* bias, long n_vox, int c, void* part,
                              void* ticket, void* out, int dtype, void* stream) {
  const NormVecs nv = {(const float*)mean, (const float*)inv, (const float*)scale,
                       (const float*)bias};
  launch_mode<RED_NORM_ACT_BWD>(g, x, nv, n_vox, c, part, ticket, out, dtype,
                                (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The norm's elementwise passes.  x, y, g, dx: (n_vox, C) of one dtype;
// mean, inv, scale, bias: (C,) f32; means: (2, C) f32; act: ACT_NONE or
// ACT_LEAKY.
int unet_norm_act(const void* x, const void* mean, const void* inv, const void* scale,
                  const void* bias, long n_vox, int c, int act, void* y, int dtype,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const NormVecs nv = {(const float*)mean, (const float*)inv, (const float*)scale,
                       (const float*)bias};
  if (act != ACT_NONE && act != ACT_LEAKY) return (int)cudaErrorInvalidValue;
  const bool leaky = act == ACT_LEAKY;
  if (dtype == DT_F32)
    (leaky ? launch_norm_act<float, true> : launch_norm_act<float, false>)(x, nv, n_vox, c, y, s);
  else
    (leaky ? launch_norm_act<__nv_bfloat16, true>
           : launch_norm_act<__nv_bfloat16, false>)(x, nv, n_vox, c, y, s);
  return (int)cudaGetLastError();
}

int unet_norm_act_dx(const void* g, const void* x, const void* mean, const void* inv,
                     const void* scale, const void* bias, const void* means, long n_vox, int c,
                     int act, void* dx, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const NormVecs nv = {(const float*)mean, (const float*)inv, (const float*)scale,
                       (const float*)bias};
  if (act != ACT_NONE && act != ACT_LEAKY) return (int)cudaErrorInvalidValue;
  const bool leaky = act == ACT_LEAKY;
  if (dtype == DT_F32)
    (leaky ? launch_norm_act_dx<float, true>
           : launch_norm_act_dx<float, false>)(g, x, nv, means, n_vox, c, dx, s);
  else
    (leaky ? launch_norm_act_dx<__nv_bfloat16, true>
           : launch_norm_act_dx<__nv_bfloat16, false>)(g, x, nv, means, n_vox, c, dx, s);
  return (int)cudaGetLastError();
}

// x: n values, 16-byte aligned; part: RED_MAX_BLOCKS f32; out: one f32.
int unet_volume_max(const void* x, long n, void* part, void* ticket, void* out, int dtype,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) {
    const long n_vec = n / Vec<float>::N;
    auto kernel = max_kernel<float>;
    kernel<<<reduce_grid((const void*)kernel, 0, n_vec), RED_THREADS, 0, s>>>(
        (const float*)x, n_vec, n, (float*)part, (unsigned int*)ticket, (float*)out);
  } else {
    const long n_vec = n / Vec<__nv_bfloat16>::N;
    auto kernel = max_kernel<__nv_bfloat16>;
    kernel<<<reduce_grid((const void*)kernel, 0, n_vec), RED_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, n_vec, n, (float*)part, (unsigned int*)ticket, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
