// Backward kernels of the training step, channels-last (D, H, W, C), f32
// accumulation, bf16 or f32 inputs.
//
// conv_dw_kernel<T, KS, STRIDE, PAD, CA_T>: the weight gradient of a
//    convolution.  One template covers three Pallas kernels:
//    K5 replaces unet_studio_tpu/ops/pallas_conv.py:583 _dw_kernel, the
//       dW of the 3^3 stride-1 conv (and of the 1->C entry conv, which
//       runs it at ops/packed.py:1260), here in f32 only: bf16 K5 runs
//       on the tensor cores (conv_tc.cu dw_tc_kernel);
//    K6 replaces unet_studio_tpu/ops/packed.py:897 _s2_dw_kernel, the dW
//       of the 3^3 stride-2 conv, here in f32 only: bf16 K6 runs on the
//       tensor cores (conv_tc.cu dw_s2_tc_kernel);
//    K9 replaces unet_studio_tpu/ops/packed.py:782 _trans_dw_kernel, the
//       dW of the ks2/stride-2 transposed conv.
//    For each tap it computes
//        out[tap][a][b] = sum_o A[STRIDE*o + tap - PAD][a] * B[o][b]
//    over the voxels o of B, taps that fall outside A read as zero.  K5
//    and K6 take A = x (the conv input) and B = g (the output gradient),
//    so out is dW as (tap, Ci, Co).  K9 is the same sum with the roles
//    swapped: dW[p] = sum_i x[i] (x) g[2i+p] is out with A = g (twice the
//    size of x), B = x, KS = 2, STRIDE = 2, PAD = 0, as (p, Co, Ci).
//    This is a GEMM with a tiny M x N (CA x CB <= 64 x 128 per tap) and K
//    = every voxel (1-8 M).  It is done in two passes: each block sums its
//    share of the voxel tiles in registers and writes its (taps, CA, CB)
//    slice of a (blocks, taps, CA, CB) f32 buffer; dw_reduce_kernel then
//    adds the blocks in a fixed order.  So the result is the same from
//    run to run.
//    A block holds one row segment of TX voxels of B (16 channels) and the
//    KS x KS x (STRIDE*(TX-1)+KS) window of A it reaches (CA_T channels)
//    in shared memory; each thread owns one tap and a 4x4 (a, b) tile (1x4
//    when A has one channel, the entry conv) and reads both operands as
//    16-byte broadcasts: 16 FMA per two shared loads.
// conv3_s2_dx_kernel (K7, replaces unet_studio_tpu/ops/packed.py:1008
//    _s2_dx_kernel, in f32; bf16 runs on the tensor cores, conv_tc.cu):
//    the input gradient of the 3^3/stride-2/pad-1 conv in gather form.  Per axis a dx voxel i = 2q + r reads tap 1 of g[q] when
//    r = 0, and tap 2 of g[q] and tap 0 of g[q+1] when r = 1: 1 to 8 g
//    voxels, no scatter and no atomics (the parity decomposition of
//    unet_studio_tpu/models/unet3d.py:288-329).  Threads of a row are
//    ordered by x parity, so a warp mostly takes one tap count.
// trans2x_dx_kernel (K8, replaces unet_studio_tpu/ops/packed.py:768
//    _trans_dx_kernel): the input gradient of the ks2/stride-2 transposed
//    conv, dx[i][ci] = sum_{p in {0,1}^3} sum_co W[ci][co][p] g[2i+p][co],
//    a ks2/stride-2 conv of g.
// The input gradient of the stride-1 conv is K1 itself (csrc/conv.cu) on
// g with flipped, transposed weights.
//
// What bounds them on the H100 (bf16, each input read once, each output
// written once).  At the flagship's level 0/1 shapes, (192,224,192,16)
// and (96,112,96,32): K5 16->16 moves 528 MB for 114 GFLOP, 0.158 ms at
// 3.35 TB/s against 0.115 ms at the bf16 tensor-core peak, so bytes bound
// it; K6, K7, K8 and K9 at 16<->32 each move 330 MB (0.099 ms) for 28.5
// GFLOP (K6, K7) or 8.5 GFLOP (K8, K9): bytes bound them too.  These run
// on the CUDA cores in f32 FMA (no wgmma, no TMA), whose 67 TFLOP/s put
// K5 at 1.7 ms at best; bf16 K5, K6 and K7 have tensor-core versions
// (conv_tc.cu), K8 and K9 are later work.

#include <type_traits>

#include "common.cuh"

#define THREADS 128
#define CO_T 16  // gradient channels staged per chunk (dx kernels)
#define CI_T 16  // dx channels per thread (and per grid.y slice)
#define DW_B 16  // B channels per dW block (four 4-wide groups)

// Row-segment length of a dW tile: the window of A stays under 48 KB.
template <int KS, int STRIDE>
struct DwTile {
  static constexpr int TX = (KS == 3 && STRIDE == 2) ? 32 : 64;
  static constexpr int WX = STRIDE * (TX - 1) + KS;  // A positions a tile reaches
};

template <typename T, int KS, int STRIDE, int PAD, int CA_T>
__global__ void __launch_bounds__(KS * KS * KS * (CA_T / (CA_T >= 4 ? 4 : 1)) * 4)
conv_dw_kernel(const T* __restrict__ A, int AD, int AH, int AW, int ca,
               const T* __restrict__ B, int BD, int BH, int BW, int cb,
               float* __restrict__ part) {
  constexpr int NT = KS * KS * KS;
  constexpr int TX = DwTile<KS, STRIDE>::TX, WX = DwTile<KS, STRIDE>::WX;
  constexpr int TA = CA_T >= 4 ? 4 : 1;  // a values per thread
  constexpr int NAG = CA_T / TA;         // a groups per tap
  constexpr int NTHR = NT * NAG * 4;     // 4 groups of 4 b values per tap
  __shared__ __align__(16) float as[KS * KS][WX][CA_T];
  __shared__ __align__(16) float bs[TX][DW_B];

  const int n_bchunk = cb / DW_B;
  const int a0 = (blockIdx.y / n_bchunk) * CA_T, b0 = (blockIdx.y % n_bchunk) * DW_B;
  const int tid = threadIdx.x;
  const int tap = tid / (NAG * 4), ag = (tid / 4) % NAG, bg = tid % 4;
  const int row = tap / KS, dx = tap % KS;  // row = dz * KS + dy

  float acc[TA][4];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int ntx = (BW + TX - 1) / TX;
  const long n_tiles = (long)BD * BH * ntx;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ox0 = (int)(tile % ntx) * TX;
    const long zy = tile / ntx;
    const int oy = (int)(zy % BH), oz = (int)(zy / BH);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TX; i += NTHR) {
      float v[16];
      if (ox0 + i < BW) {
        load16(B + (((long)oz * BH + oy) * BW + ox0 + i) * cb + b0, v);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(&bs[i][0]);
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
    for (int i = tid; i < KS * KS * WX; i += NTHR) {
      const int r = i / WX, wx = i % WX;
      const int iz = STRIDE * oz + r / KS - PAD, iy = STRIDE * oy + r % KS - PAD;
      const int ix = STRIDE * ox0 + wx - PAD;
      const bool in = iz >= 0 && iz < AD && iy >= 0 && iy < AH && ix >= 0 && ix < AW;
      const T* p = A + (((long)iz * AH + iy) * AW + ix) * ca + a0;
      if constexpr (CA_T == 16) {
        float v[16];
        if (in) {
          load16(p, v);
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) v[k] = 0.0f;
        }
        float4* dst = reinterpret_cast<float4*>(&as[r][wx][0]);
#pragma unroll
        for (int k = 0; k < 4; ++k) dst[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      } else {
        as[r][wx][0] = in ? to_f(*p) : 0.0f;
      }
    }
    __syncthreads();
    const float* ap = &as[row][dx][ag * TA];
#pragma unroll 4
    for (int i = 0; i < TX; ++i) {
      float av[TA];
      if constexpr (TA == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(ap + i * STRIDE * CA_T);
        av[0] = a4.x;
        av[1] = a4.y;
        av[2] = a4.z;
        av[3] = a4.w;
      } else {
        av[0] = ap[i * STRIDE * CA_T];
      }
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[i][bg * 4]);
#pragma unroll
      for (int k = 0; k < TA; ++k) {
        acc[k][0] = fmaf(av[k], b4.x, acc[k][0]);
        acc[k][1] = fmaf(av[k], b4.y, acc[k][1]);
        acc[k][2] = fmaf(av[k], b4.z, acc[k][2]);
        acc[k][3] = fmaf(av[k], b4.w, acc[k][3]);
      }
    }
  }
  float* out = part + ((long)blockIdx.x * NT + tap) * ca * cb;
#pragma unroll
  for (int k = 0; k < TA; ++k) {
    float4* dst = reinterpret_cast<float4*>(out + (long)(a0 + ag * TA + k) * cb + b0 + bg * 4);
    *dst = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
}

// out[i] = sum over blocks k of part[k][i] in a fixed order: a block takes
// 32 consecutive i (one per lane, coalesced), its RED_W warps the blocks k
// = warp, warp + RED_W, ... in order, then the warp sums are added in warp
// order.  8 warps for the dW partials; 32 where there are few outputs and
// many rows (the conv forward's stats: 2 co values per block).
#define RED_I 32
template <int RED_W>
__global__ void __launch_bounds__(RED_I * RED_W)
dw_reduce_kernel(const float* __restrict__ part, int nblk, long n, float* __restrict__ out) {
  __shared__ float sums[RED_W][RED_I];
  const int lane = threadIdx.x % RED_I, warp = threadIdx.x / RED_I;
  const long i = (long)blockIdx.x * RED_I + lane;
  float s = 0.0f;
  if (i < n)
#pragma unroll 4
    for (int k = warp; k < nblk; k += RED_W) s += part[(long)k * n + i];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < RED_W; ++w) t += sums[w][lane];
    out[i] = t;
  }
}
#define RED_FEW 256  // n up to this many: the 32-warp form

// taps of one axis that reach dx coordinate i = 2q + r of a 3/stride-2/pad-1
// conv with O outputs: (weight tap, g coordinate) pairs
__device__ __forceinline__ int s2_axis_taps(int i, int O, int* k, int* q) {
  const int h = i >> 1;
  if ((i & 1) == 0) {
    k[0] = 1;
    q[0] = h;
    return 1;
  }
  k[0] = 2;
  q[0] = h;
  if (h + 1 < O) {
    k[1] = 0;
    q[1] = h + 1;
    return 2;
  }
  return 1;
}

// g: (D/2, H/2, W/2, co); w: (27, co, ci); dx: (D, H, W, ci)
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3_s2_dx_kernel(const T* __restrict__ g, int co, const T* __restrict__ w,
                   T* __restrict__ dx, int D, int H, int W, int ci) {
  __shared__ float ws[27][CO_T][CI_T];
  const int OD = D / 2, OH = H / 2, OW = W / 2;
  const long n = (long)D * H * W;
  const long t = (long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = t < n;
  const int ci0 = blockIdx.y * CI_T;
  // within a row, threads [0, W/2) take the even x and [W/2, W) the odd x
  const int xi = (int)(t % W);
  const int iy = (int)((t / W) % H), iz = (int)(t / ((long)W * H));
  const int rx = xi >= OW ? 1 : 0;
  const int ix = 2 * (xi - rx * OW) + rx;
  int kz[2], qz[2], ky[2], qy[2], kx[2], qx[2];
  int nz = 0, ny = 0, nx = 0;
  if (valid) {
    nz = s2_axis_taps(iz, OD, kz, qz);
    ny = s2_axis_taps(iy, OH, ky, qy);
    nx = s2_axis_taps(ix, OW, kx, qx);
  }

  float acc[CI_T];
#pragma unroll
  for (int j = 0; j < CI_T; ++j) acc[j] = 0.0f;
  for (int c0 = 0; c0 < co; c0 += CO_T) {
    __syncthreads();
    for (int i = threadIdx.x; i < 27 * CO_T * CI_T; i += THREADS) {
      const int j = i % CI_T, c = (i / CI_T) % CO_T, tap = i / (CI_T * CO_T);
      ws[tap][c][j] = to_f(w[((long)tap * co + c0 + c) * ci + ci0 + j]);
    }
    __syncthreads();
    for (int a = 0; a < nz; ++a) {
      for (int b = 0; b < ny; ++b) {
        for (int e = 0; e < nx; ++e) {
          float v[CO_T];
          load16(g + (((long)qz[a] * OH + qy[b]) * OW + qx[e]) * co + c0, v);
          const float* wt = &ws[(kz[a] * 3 + ky[b]) * 3 + kx[e]][0][0];
#pragma unroll
          for (int c = 0; c < CO_T; ++c) {
#pragma unroll
            for (int j = 0; j < CI_T; ++j) acc[j] = fmaf(v[c], wt[c * CI_T + j], acc[j]);
          }
        }
      }
    }
  }
  if (valid) store16(dx + (((long)iz * H + iy) * W + ix) * ci + ci0, acc);
}

// g: (2D, 2H, 2W, co); w: (8, co, ci) parity-major; dx: (D, H, W, ci)
template <typename T>
__global__ void __launch_bounds__(THREADS)
trans2x_dx_kernel(const T* __restrict__ g, int co, const T* __restrict__ w,
                  T* __restrict__ dx, int D, int H, int W, int ci) {
  __shared__ float ws[8][CO_T][CI_T];
  const long n = (long)D * H * W;
  const long vox = (long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = vox < n;
  const int ci0 = blockIdx.y * CI_T;
  const int x = (int)(vox % W), y = (int)((vox / W) % H), z = (int)(vox / ((long)W * H));

  float acc[CI_T];
#pragma unroll
  for (int j = 0; j < CI_T; ++j) acc[j] = 0.0f;
  for (int c0 = 0; c0 < co; c0 += CO_T) {
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * CO_T * CI_T; i += THREADS) {
      const int j = i % CI_T, c = (i / CI_T) % CO_T, p = i / (CI_T * CO_T);
      ws[p][c][j] = to_f(w[((long)p * co + c0 + c) * ci + ci0 + j]);
    }
    __syncthreads();
    if (!valid) continue;
#pragma unroll 1
    for (int p = 0; p < 8; ++p) {
      const int gz = 2 * z + (p >> 2), gy = 2 * y + ((p >> 1) & 1), gx = 2 * x + (p & 1);
      float v[CO_T];
      load16(g + (((long)gz * 2 * H + gy) * 2 * W + gx) * co + c0, v);
      const float* wt = &ws[p][0][0];
#pragma unroll
      for (int c = 0; c < CO_T; ++c) {
#pragma unroll
        for (int j = 0; j < CI_T; ++j) acc[j] = fmaf(v[c], wt[c * CI_T + j], acc[j]);
      }
    }
  }
  if (valid) store16(dx + vox * ci + ci0, acc);
}

template <typename T, int KS, int STRIDE, int PAD, int CA_T>
static void launch_dw(const void* a, int ad, int ah, int aw, int ca, const void* b, int bd,
                      int bh, int bw, int cb, float* part, int nblk, cudaStream_t s) {
  constexpr int NTHR = KS * KS * KS * (CA_T / (CA_T >= 4 ? 4 : 1)) * 4;
  const dim3 grid((unsigned)nblk, (unsigned)((ca / CA_T) * (cb / DW_B)));
  conv_dw_kernel<T, KS, STRIDE, PAD, CA_T><<<grid, NTHR, 0, s>>>(
      (const T*)a, ad, ah, aw, ca, (const T*)b, bd, bh, bw, cb, part);
}

template <typename T>
static int dispatch_dw(const void* a, int ad, int ah, int aw, int ca, const void* b, int bd,
                       int bh, int bw, int cb, int ks, int stride, int pad, float* part,
                       int nblk, cudaStream_t s) {
  constexpr bool F32 = std::is_same<T, float>::value;  // bf16 K5 and K6 are conv_tc.cu's
  if (F32 && ks == 3 && stride == 1 && pad == 1 && ca == 1)
    launch_dw<float, 3, 1, 1, 1>(a, ad, ah, aw, ca, b, bd, bh, bw, cb, part, nblk, s);
  else if (F32 && ks == 3 && stride == 1 && pad == 1)
    launch_dw<float, 3, 1, 1, 16>(a, ad, ah, aw, ca, b, bd, bh, bw, cb, part, nblk, s);
  else if (F32 && ks == 3 && stride == 2 && pad == 1)
    launch_dw<float, 3, 2, 1, 16>(a, ad, ah, aw, ca, b, bd, bh, bw, cb, part, nblk, s);
  else if (ks == 2 && stride == 2 && pad == 0)
    launch_dw<T, 2, 2, 0, 16>(a, ad, ah, aw, ca, b, bd, bh, bw, cb, part, nblk, s);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int unet_dw_reduce(const void* part, int nblk, long n, void* out, void* stream);

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 on
// success).  The Python wrappers (ops/conv.py) have checked dtype,
// shapes, contiguity, 16-byte alignment and the channel counts: ca is 1
// (ks 3, stride 1 only) or a multiple of 16, cb, co and ci multiples of 16.
// dtype bf16 with ks 3 has no instance here (conv_tc.cu's): bf16 takes
// K9's ks 2 only.

// part: (nblk, ks^3, ca, cb) f32 scratch; out: (ks^3, ca, cb) f32
int unet_conv_dw(const void* a, int ad, int ah, int aw, int ca, const void* b, int bd, int bh,
                 int bw, int cb, int ks, int stride, int pad, void* part, int nblk, void* out,
                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = dtype == DT_F32
                     ? dispatch_dw<float>(a, ad, ah, aw, ca, b, bd, bh, bw, cb, ks, stride, pad,
                                          (float*)part, nblk, s)
                     : dispatch_dw<__nv_bfloat16>(a, ad, ah, aw, ca, b, bd, bh, bw, cb, ks,
                                                  stride, pad, (float*)part, nblk, s);
  if (rc != 0) return rc;
  return unet_dw_reduce(part, nblk, (long)ks * ks * ks * ca * cb, out, stream);
}

// out[i] = sum over k < nblk, in order, of part[k * n + i]: the second pass
// of every dW kernel (conv_tc.cu's dw_tc_kernel too) and of the forward
// convs' stats (conv.cu, conv_tc.cu)
int unet_dw_reduce(const void* part, int nblk, long n, void* out, void* stream) {
  const unsigned grid = (unsigned)((n + RED_I - 1) / RED_I);
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= RED_FEW)
    dw_reduce_kernel<32><<<grid, RED_I * 32, 0, s>>>((const float*)part, nblk, n, (float*)out);
  else
    dw_reduce_kernel<8><<<grid, RED_I * 8, 0, s>>>((const float*)part, nblk, n, (float*)out);
  return (int)cudaGetLastError();
}

// f32 only (bf16 is conv_tc.cu's): g (D/2, H/2, W/2, co), w (27, co, ci),
// dx (D, H, W, ci)
int unet_conv3_s2_dx(const void* g, int co, const void* w, void* dx, int D, int H, int W, int ci,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long n = (long)D * H * W;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS), ci / CI_T);
  conv3_s2_dx_kernel<float><<<grid, THREADS, 0, s>>>((const float*)g, co, (const float*)w,
                                                     (float*)dx, D, H, W, ci);
  return (int)cudaGetLastError();
}

// g: (2D, 2H, 2W, co), w: (8, co, ci), dx: (D, H, W, ci)
int unet_trans2x_dx(const void* g, int co, const void* w, void* dx, int D, int H, int W, int ci,
                    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long n = (long)D * H * W;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS), ci / CI_T);
  if (dtype == DT_F32)
    trans2x_dx_kernel<float><<<grid, THREADS, 0, s>>>((const float*)g, co, (const float*)w,
                                                      (float*)dx, D, H, W, ci);
  else
    trans2x_dx_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)g, co, (const __nv_bfloat16*)w, (__nv_bfloat16*)dx, D, H, W, ci);
  return (int)cudaGetLastError();
}

}  // extern "C"
