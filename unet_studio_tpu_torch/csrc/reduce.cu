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
//   reductions of the instance norm's backward;
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

#include "common.cuh"

#define RED_THREADS 512
#define RED_UNROLL 4
#define RED_MAX_BLOCKS 1024  // ops/reduce.py sizes the partial buffer by it

// Per-channel modes of channel_reduce_kernel (rows of its output)
#define RED_SUM 0       // out[0] = sum x
#define RED_SUM_SQ 1    // out[0] = sum x, out[1] = sum x^2
#define RED_SQDIFF 2    // out[0] = sum (x - mean)^2
#define RED_NORM_BWD 3  // out[0] = sum g, out[1] = sum g * (x - mean) * inv

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
};

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
// a: the volume (g for RED_NORM_BWD); b: x for RED_NORM_BWD, else unused;
// mean: (C,) f32 for RED_SQDIFF and RED_NORM_BWD; inv: (C,) for
// RED_NORM_BWD; part: (gridDim.x, rows, C) scratch; ticket: the stream's
// ticket; out: (rows, C).
template <typename T, int MODE>
__global__ void __launch_bounds__(RED_THREADS)
channel_reduce_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ mean, const float* __restrict__ inv, long n_vec,
                      int c, float* __restrict__ part, unsigned int* ticket,
                      float* __restrict__ out) {
  using V = Vec<T>;
  constexpr int N = V::N;
  constexpr int ROWS = (MODE == RED_SUM_SQ || MODE == RED_NORM_BWD) ? 2 : 1;
  constexpr bool TWO = MODE == RED_NORM_BWD;
  extern __shared__ float sh[];

  const int tid = threadIdx.x;
  const int cbase = (tid * N) % c;  // the block's stride is a multiple of C
  float v[ROWS][N], m[N], iv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r][k] = 0.0f;
    m[k] = (MODE == RED_SQDIFF || TWO) ? mean[cbase + k] : 0.0f;
    iv[k] = TWO ? inv[cbase + k] : 0.0f;
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

template <typename T, int MODE>
static void launch_channels(const void* a, const void* b, const void* mean, const void* inv,
                            long n_vox, int c, void* part, void* ticket, void* out,
                            cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  constexpr int ROWS = (MODE == RED_SUM_SQ || MODE == RED_NORM_BWD) ? 2 : 1;
  const long n_vec = n_vox * c / N;
  const int smem = reduce_smem_floats(ROWS, c, N) * (int)sizeof(float);
  auto kernel = channel_reduce_kernel<T, MODE>;
  const unsigned grid = reduce_grid((const void*)kernel, smem, n_vec);
  kernel<<<grid, RED_THREADS, smem, s>>>((const T*)a, (const T*)b, (const float*)mean,
                                         (const float*)inv, n_vec, c, (float*)part,
                                         (unsigned int*)ticket, (float*)out);
}

template <int MODE>
static void launch_mode(const void* a, const void* b, const void* mean, const void* inv,
                        long n_vox, int c, void* part, void* ticket, void* out, int dtype,
                        cudaStream_t s) {
  if (dtype == DT_F32)
    launch_channels<float, MODE>(a, b, mean, inv, n_vox, c, part, ticket, out, s);
  else
    launch_channels<__nv_bfloat16, MODE>(a, b, mean, inv, n_vox, c, part, ticket, out, s);
}

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 on success).
// The wrappers (ops/reduce.py) have checked dtype, contiguity, 16-byte
// alignment and C.  part: RED_MAX_BLOCKS * rows * C f32 scratch (rows: 2
// for RED_SUM_SQ and RED_NORM_BWD, else 1), its contents unused; ticket:
// one unsigned int, 0 at allocation, never touched between launches; both
// belong to the launch's stream.  out: (rows, C) f32, uninitialised.

// mode: RED_SUM, RED_SUM_SQ or RED_SQDIFF; mean: (C,) f32 for RED_SQDIFF,
// else unused.
int unet_channel_moments(const void* x, const void* mean, long n_vox, int c, int mode,
                         void* part, void* ticket, void* out, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == RED_SUM)
    launch_mode<RED_SUM>(x, nullptr, mean, nullptr, n_vox, c, part, ticket, out, dtype, s);
  else if (mode == RED_SUM_SQ)
    launch_mode<RED_SUM_SQ>(x, nullptr, mean, nullptr, n_vox, c, part, ticket, out, dtype, s);
  else if (mode == RED_SQDIFF)
    launch_mode<RED_SQDIFF>(x, nullptr, mean, nullptr, n_vox, c, part, ticket, out, dtype, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g, x: (n_vox, C) of one dtype; mean, inv: (C,) f32; out: (2, C).
int unet_channel_norm_bwd(const void* g, const void* x, const void* mean, const void* inv,
                          long n_vox, int c, void* part, void* ticket, void* out, int dtype,
                          void* stream) {
  launch_mode<RED_NORM_BWD>(g, x, mean, inv, n_vox, c, part, ticket, out, dtype,
                            (cudaStream_t)stream);
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
