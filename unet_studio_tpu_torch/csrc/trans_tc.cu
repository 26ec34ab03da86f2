// bf16 tensor-core kernels of the ks2/stride-2 transposed convolution,
// channels-last (D, H, W, C), f32 accumulation: the route of every bf16
// call of K4 (conv_trans2x), K8 (conv_trans2x_dx) and K9 (conv_trans2x_dw)
// for the (Ci, Co) of ops/tc_layout.py TRANS_PAIRS, (32, 16) and (64, 32).
// f32 calls keep the FMA kernels (conv.cu trans2x_kernel, conv_bwd.cu
// trans2x_dx_kernel and conv_dw_kernel with KS = 2), the exact oracle.
//
// K4 trans2x_tc_kernel<CI, CO> replaces unet_studio_tpu/ops/packed.py:439
//    _trans_kernel (conv_trans2x_up):
//      y[2v + (rz, ry, rx)][co] = sum_ci act(a x[v] + b)[ci] W[ci][co][rz][ry][rx] + bias[co].
// K8 trans2x_dx_tc_kernel<CI, CO> replaces unet_studio_tpu/ops/packed.py:768
//    _trans_dx_kernel (in conv_trans2x_p's VJP):
//      dx[v][ci] = sum_(rz, ry, rx) sum_co W[ci][co][rz][ry][rx] g[2v + (rz, ry, rx)][co].
// K9 dw_trans_tc_kernel<CI, CO> replaces unet_studio_tpu/ops/packed.py:782
//    _trans_dw_kernel (with _trans_extract_dw, in conv_trans2x_p's VJP):
//      dW[ci][co][rz][ry][rx] = sum_v x[v][ci] g[2v + (rz, ry, rx)][co].
//
// What bounds them on the H100: at the flagship's level 0, x or dx (96,
// 112, 96, 32) and y or g (192, 224, 192, 16) in bf16, each moves 330 MB
// (x 66 MB, the 8x larger volume 264 MB) for 8.5 GFLOP, 26 op/byte: 0.0986
// ms at 3.35 TB/s against 0.0086 ms at the bf16 tensor-core peak, so
// bytes.  An output voxel (K4) or a g voxel (K8, K9) meets one voxel of
// the small volume: no halo, no padding, every byte is read or written
// once, and the kernels' work is to keep the 8x larger volume streaming at
// full rate; the MMAs are a small part of their time.
//
// All three walk k-rows: the run of 16 voxels of the small volume from (z,
// y, x0).  For a parity slice s = (rz, ry), the 2 Co values (rx, co) of
// the run's voxel m are the 2 Co elements from m * 2 Co on of one
// contiguous span of the 2x-size volume's row (2z + rz, 2y + ry) from x =
// 2 x0 (ops/tc_layout.py trans_span): 16 rows of 2 Co, 1 KB at Co = 16.
//
// K4: one GEMM per k-row, M = its 16 input voxels, K = Ci (2 or 4 k-steps),
//    N = 8 Co in (rz, ry, rx, co) order (tc_layout.k4_weight_matrix).  The
//    weights (8 or 32 KB, packed by pack_weights(w, "k4")) stay in shared
//    memory for the persistent block, and each warp walks its k-rows on its
//    own: it cp.asyncs the next k-row of x into its XOR-swizzled double
//    buffer while this one computes, applies the prologue once per staged
//    element (rounded to bf16, as apply_prologue), loads the A fragments
//    once and walks the 4 slices over them (N = 2 Co, 16 or 32 f32
//    accumulators a lane): bias in f32, bf16, into the warp's swizzled
//    staging rows, and the slice's span leaves as 16-byte coalesced stores,
//    voxels past the row's end (any W) masked.  The kernel writes 4x what it
//    reads, so the store path is the design: whole spans, no block barrier.
// K8: K4's GEMM read the other way: per k-row, M = its 16 dx voxels, K = 8
//    Co in (rz, ry, rx, co) order (the 4 slices' spans one after the other,
//    2 or 4 k-steps each), N = Ci (16 or 32 f32 accumulators a lane), B =
//    pack_weights(w, "k8"), K4's matrix transposed, resident in shared
//    memory (8 or 32 KB).  The kernel reads 4x what it writes, so the load
//    path is the design: each warp walks its k-rows with a private 3-deep
//    ring of cp.async stages (one k-row's 4 spans, 4 or 8 KB, XOR-swizzled,
//    zero past the row's end), so two k-rows of g are in flight while one
//    computes (96 or 64 KB in flight per SM, at 3 or 1 blocks of 60 or 136
//    KB per SM); the A fragments come through plain ldmatrix (the spans
//    are voxel-major with K contiguous).  The 16 dx voxels (1 or 2 KB,
//    contiguous in dx) go through swizzled staging as bf16 and leave as
//    16-byte coalesced stores, voxels past the row's end masked.  No
//    atomics: bitwise repeatable.
// K9: per k-row and slice, a GEMM with M = Ci (m-tiles of 16), N = 2 Co
//    (rx, co), K = the k-row's 16 voxels: A = x's k-row and B = the slice's
//    g span as 16 rows of 2 Co, both voxel-major (K-major), so both come
//    through ldmatrix.trans.  A block stages TR k-rows of x and their 4 g
//    spans each (40 KB) with cp.async, double-buffered, chunks swizzled per
//    row; warp w owns slice w / 2 and half of the m-tiles, its accumulators
//    in registers over the persistent walk (Ci x 8 Co f32 per block).  The
//    block writes its partial, (blocks, 8, Ci, Co) f32, and unet_dw_reduce
//    (conv_bwd.cu) adds them in order: no atomics, bitwise repeatable.  The
//    grid is one wave, capped so that the partials stay within an eighth of
//    the inputs' bytes (tc_layout.trans_dw_blocks).
// Their geometry is ops/tc_layout.py's (k4_*, trans_*), replayed on the CPU
// by tests/test_torch_conv_tiles.py and test_torch_dw_tiles.py.

#include "tc.cuh"

#define TDW_WARPS 8  // K9: two warps per parity slice
#define TDW_THREADS (TDW_WARPS * 32)

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <int CI, int CO>
struct TransCfg {
  static constexpr int NC = CI / 8;          // 16-byte chunks per input voxel
  static constexpr int KS = CI / 16;         // k-steps
  static constexpr int SN = 2 * CO;          // columns of a parity slice, (rx, co)
  static constexpr int SNT = SN / 8;         // its n-tiles
  static constexpr int NCO = SN * 2 / 16;    // 16-byte chunks per staged output row
  static constexpr int NPAIR = 8 * CO / 16;  // packed n-tile pairs per k-step
  static constexpr int X_BYTES = TC_TX * CI * 2;
  static constexpr int STG_BYTES = TC_TX * SN * 2;
  static constexpr int WARP_BYTES = 2 * X_BYTES + STG_BYTES;
  static constexpr int W_BYTES = KS * NPAIR * 512;
  static constexpr int SMEM = W_BYTES + TC_WARPS * WARP_BYTES;
  static_assert(SNT == NCO, "one n-tile per staged chunk");
};

template <int CI, int CO>
__global__ void __launch_bounds__(TC_THREADS)
trans2x_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ pa,
                  const float* __restrict__ pb, int act, const unsigned char* __restrict__ wpk,
                  const float* __restrict__ bias_g, __nv_bfloat16* __restrict__ y, int D, int H,
                  int W) {
  using C = TransCfg<CI, CO>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float bias[CO];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  unsigned char* wbuf = smem;
  unsigned char* xbuf = smem + C::W_BYTES + warp * C::WARP_BYTES;  // this warp's two k-rows
  unsigned char* stg = xbuf + 2 * C::X_BYTES;                       // one slice's output rows
  const uint32_t x_u32 = smem_u32(xbuf);
  for (int i = threadIdx.x; i < CO; i += TC_THREADS) bias[i] = bias_g[i];

  const int ntx = (W + TC_TX - 1) / TC_TX;
  const long nrows = (long)ntx * H * D;  // k-rows, x fastest
  const long step = (long)gridDim.x * TC_WARPS;
  long kr = (long)blockIdx.x * TC_WARPS + warp;

  // cp.async the 16 voxels of k-row r into buffer b, zero past the row's end
  auto stage = [&](long r, int b) {
    const int x0 = (int)(r % ntx) * TC_TX;
    const __nv_bfloat16* src = x + ((r / ntx) * W + x0) * CI;
    unsigned char* dst = xbuf + b * C::X_BYTES;
#pragma unroll
    for (int i = lane; i < TC_TX * C::NC; i += 32) {
      const int v = i / C::NC, pc = i % C::NC;
      const bool in = x0 + v < W;
      cp_async16(dst + i * 16, in ? src + v * CI + swz<C::NC>(v, pc) * 8 : x, in ? 16 : 0);
    }
  };

  copy_async(wbuf, wpk, C::W_BYTES);
  if (kr < nrows) stage(kr, 0);
  cp_async_commit();
  // a lane's prologue chunks all hold the same 8 channels (logical chunk
  // lane % NC), whose a and b it keeps in registers
  const int pch = lane % C::NC;
  float fa[8], fb[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    fa[k] = pa != nullptr ? pa[pch * 8 + k] : 1.0f;
    fb[k] = pa != nullptr ? pb[pch * 8 + k] : 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();  // the weights, the bias and each warp's first k-row are in place

  int buf = 0;
  for (; kr < nrows; kr += step, buf ^= 1) {
    __syncwarp();  // every lane is done with the buffer the next stage fills
    if (kr + step < nrows) stage(kr + step, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this k-row's copies have landed (the next one's may fly)
    __syncwarp();        // ... every lane's
    unsigned char* xs = xbuf + buf * C::X_BYTES;
    if (pa != nullptr) {
#pragma unroll
      for (int k = 0; k < C::NC / 2; ++k) {
        const int v = lane / C::NC + k * (32 / C::NC);
        prologue_chunk(xs + v * CI * 2 + swz<C::NC>(v, pch) * 16, fa, fb, act);
      }
      __syncwarp();
    }
    uint32_t a[C::KS][4];
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      const int v = lane & 15;
      ldsm_x4(a[ks], x_u32 + buf * C::X_BYTES + v * CI * 2 +
                         swz<C::NC>(v, ks * 2 + (lane >> 4)) * 16);
    }
    const int x0 = (int)(kr % ntx) * TC_TX;
    const long zy = kr / ntx;
    const int yy = (int)(zy % H), zz = (int)(zy / H);
    const int nv = min(TC_TX, W - x0);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float acc[C::SNT][4];
#pragma unroll
      for (int nt = 0; nt < C::SNT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        uint32_t b[C::SNT][2];
        load_b<C::SN>(b, wbuf + (ks * C::NPAIR + s * (C::SN / 16)) * 512, lane);
#pragma unroll
        for (int nt = 0; nt < C::SNT; ++nt) mma_bf16(acc[nt], a[ks], b[nt][0], b[nt][1]);
      }
      // bias in f32, bf16, into staging rows gq and gq + 8 (n-tile nt is
      // logical chunk nt of a row)
#pragma unroll
      for (int nt = 0; nt < C::SNT; ++nt) {
        const int co = (nt * 8 + 2 * t) % CO;
        const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = gq + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(stg + m * C::SN * 2 + swz<C::NCO>(m, nt) * 16 +
                                             4 * t) =
              __floats2bfloat162_rn(acc[nt][2 * h] + b0, acc[nt][2 * h + 1] + b1);
        }
      }
      __syncwarp();
      __nv_bfloat16* dst =
          y + (((long)(2 * zz + (s >> 1)) * 2 * H + 2 * yy + (s & 1)) * 2 * W + 2 * x0) * CO;
#pragma unroll
      for (int i = lane; i < TC_TX * C::NCO; i += 32) {
        const int m = i / C::NCO, c = i % C::NCO;
        if (m < nv)
          *reinterpret_cast<uint4*>(dst + m * C::SN + c * 8) =
              *reinterpret_cast<const uint4*>(stg + m * C::SN * 2 + swz<C::NCO>(m, c) * 16);
      }
      __syncwarp();  // the rows are read before the next slice writes them
    }
  }
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

template <int CI, int CO>
struct TransDxCfg {
  static constexpr int SN = 2 * CO;       // (rx, co) columns of a slice's span row
  static constexpr int NCG = SN / 8;      // 16-byte chunks per span row
  static constexpr int KSS = SN / 16;     // k-steps per slice
  static constexpr int KS = 4 * KSS;      // k-steps, K = 8 Co
  static constexpr int NT = CI / 8;       // n-tiles
  static constexpr int NPAIR = CI / 16;   // packed n-tile pairs per k-step
  static constexpr int NCO = CI / 8;      // 16-byte chunks per staged dx row
  static constexpr int STAGES = 3;        // each warp's ring of k-rows
  static constexpr int G_BYTES = 4 * TC_TX * SN * 2;
  static constexpr int STG_BYTES = TC_TX * CI * 2;
  static constexpr int WARP_BYTES = STAGES * G_BYTES + STG_BYTES;
  static constexpr int W_BYTES = KS * NPAIR * 512;
  static constexpr int SMEM = W_BYTES + TC_WARPS * WARP_BYTES;
};

template <int CI, int CO>
__global__ void __launch_bounds__(TC_THREADS)
trans2x_dx_tc_kernel(const __nv_bfloat16* __restrict__ g, const unsigned char* __restrict__ wpk,
                     __nv_bfloat16* __restrict__ dx, int D, int H, int W) {
  using C = TransDxCfg<CI, CO>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  unsigned char* wbuf = smem;
  unsigned char* gbuf = smem + C::W_BYTES + warp * C::WARP_BYTES;  // this warp's ring
  unsigned char* stg = gbuf + C::STAGES * C::G_BYTES;               // its dx rows
  const uint32_t g_u32 = smem_u32(gbuf);

  const int ntx = (W + TC_TX - 1) / TC_TX;
  const long nrows = (long)ntx * H * D;  // k-rows of dx, x fastest
  const long step = (long)gridDim.x * TC_WARPS;
  long kr = (long)blockIdx.x * TC_WARPS + warp;

  // cp.async the 4 g spans of k-row r into ring slot b: row s * 16 + m
  // holds voxel m's (rx, co) of slice s; zero past the row's end
  auto stage = [&](long r, int b) {
    const int x0 = (int)(r % ntx) * TC_TX;
    const long zy = r / ntx;
    const int yy = (int)(zy % H), zz = (int)(zy / H);
    const int nv = min(TC_TX, W - x0);
    const __nv_bfloat16* base = g + (((long)(2 * zz) * 2 * H + 2 * yy) * 2 * W + 2 * x0) * CO;
    unsigned char* dst = gbuf + b * C::G_BYTES;
#pragma unroll
    for (int i = lane; i < 4 * TC_TX * C::NCG; i += 32) {
      const int row = i / C::NCG, pc = i % C::NCG, s = row / TC_TX, m = row % TC_TX;
      const bool in = m < nv;
      const __nv_bfloat16* src = base + (long)((s >> 1) * 2 * H + (s & 1)) * 2 * W * CO +
                                 m * C::SN + swz<C::NCG>(row, pc) * 8;
      cp_async16(dst + i * 16, in ? src : g, in ? 16 : 0);
    }
  };

  copy_async(wbuf, wpk, C::W_BYTES);
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < C::STAGES - 1; ++k) {
    if (kr + k * step < nrows) stage(kr + k * step, k);
    cp_async_commit();
  }
  cp_async_wait<C::STAGES - 1>();  // this thread's share of the weights has landed
  __syncthreads();                 // ... every thread's

  int slot = 0;
  for (; kr < nrows; kr += step, slot = slot == C::STAGES - 1 ? 0 : slot + 1) {
    __syncwarp();  // every lane is done with the slot the next stage fills, and the staging rows
    const long ahead = kr + (C::STAGES - 1) * step;
    if (ahead < nrows) stage(ahead, slot == 0 ? C::STAGES - 1 : slot - 1);
    cp_async_commit();
    cp_async_wait<C::STAGES - 1>();  // this k-row's spans have landed (two more may fly)
    __syncwarp();                    // ... every lane's
    const uint32_t gs = g_u32 + slot * C::G_BYTES;
    float acc[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      // k-step ks: chunks 2j, 2j + 1 of the 16 span rows of slice ks / KSS
      const int j = ks % C::KSS, row = (ks / C::KSS) * TC_TX + (lane & 15);
      uint32_t a[4], b[C::NT][2];
      ldsm_x4(a, gs + row * C::SN * 2 + swz<C::NCG>(row, 2 * j + (lane >> 4)) * 16);
      load_b<CI>(b, wbuf + ks * C::NPAIR * 512, lane);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) mma_bf16(acc[nt], a, b[nt][0], b[nt][1]);
    }
    // bf16 into staging rows gq and gq + 8 (n-tile nt is logical chunk nt of a row)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = gq + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(stg + m * CI * 2 + swz<C::NCO>(m, nt) * 16 + 4 * t) =
            __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    __syncwarp();
    const int x0 = (int)(kr % ntx) * TC_TX;
    const int nv = min(TC_TX, W - x0);
    __nv_bfloat16* dst = dx + ((kr / ntx) * W + x0) * CI;
#pragma unroll
    for (int i = lane; i < TC_TX * C::NCO; i += 32) {
      const int m = i / C::NCO, c = i % C::NCO;
      if (m < nv)
        *reinterpret_cast<uint4*>(dst + m * CI + c * 8) =
            *reinterpret_cast<const uint4*>(stg + m * CI * 2 + swz<C::NCO>(m, c) * 16);
    }
  }
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

template <int CI, int CO>
struct TransDwCfg {
  static constexpr int TR = CI == 32 ? 8 : 4;  // k-rows per tile (tc_layout.trans_dw_krows)
  static constexpr int NC = CI / 8;            // 16-byte chunks per x voxel
  static constexpr int SN = 2 * CO;            // columns of a parity slice, (rx, co)
  static constexpr int NCG = SN / 8;           // 16-byte chunks per row of a g span
  static constexpr int MTW = CI / 32;          // m-tiles per warp (half of them)
  static constexpr int NQ = SN / 16;           // n-tile pairs, one ldmatrix.x4.trans each
  static constexpr int X_BYTES = TR * TC_TX * CI * 2;
  static constexpr int G_BYTES = TR * 4 * TC_TX * SN * 2;
  static constexpr int STAGE_BYTES = X_BYTES + G_BYTES;
  static constexpr int SMEM = 2 * STAGE_BYTES;
  static_assert(2 * (SMEM + 1024) <= 233472, "two blocks fit an SM (TRANS_DW_BLOCKS_PER_SM)");
};

template <int CI, int CO>
__global__ void __launch_bounds__(TDW_THREADS, 2)
dw_trans_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                   int D, int H, int W, float* __restrict__ part) {
  using C = TransDwCfg<CI, CO>;
  extern __shared__ __align__(128) unsigned char smem[];
  // per stage buffer, the tile's k-rows: element offsets in x and in g
  // (slice 0), and valid voxels (0 past the last k-row)
  __shared__ long row_x[2][C::TR], row_g[2][C::TR];
  __shared__ int row_n[2][C::TR];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = warp >> 1, mt0 = (warp & 1) * C::MTW;  // this warp's slice and m-tiles
  const int a_row = dw_a_row(lane), a_chunk = dw_a_chunk(lane);
  const int b_row = dw_b_row(lane), b_chunk = dw_b_chunk(lane);
  const int ntx = (W + TC_TX - 1) / TC_TX;
  const long nrows = (long)ntx * H * D;
  const long ntiles = (nrows + C::TR - 1) / C::TR;

  // stage x's k-rows and their g spans of `tile` into buffer `buf`
  auto stage = [&](long tile, int buf) {
    if (tid < C::TR) {
      const long r = tile * C::TR + tid;
      const int x0 = (int)(r % ntx) * TC_TX;
      const long zy = r / ntx;
      const int yy = (int)(zy % H), zz = (int)(zy / H);
      row_n[buf][tid] = r < nrows ? min(TC_TX, W - x0) : 0;
      row_x[buf][tid] = (zy * W + x0) * CI;
      row_g[buf][tid] = (((long)(2 * zz) * 2 * H + 2 * yy) * 2 * W + 2 * x0) * CO;
    }
    __syncthreads();
    unsigned char* xs = smem + buf * C::STAGE_BYTES;
    unsigned char* gs = xs + C::X_BYTES;
    for (int i = tid; i < C::TR * TC_TX * C::NC; i += TDW_THREADS) {
      const int row = i / C::NC, pc = i % C::NC, r = row / TC_TX, v = row % TC_TX;
      const bool in = v < row_n[buf][r];
      const __nv_bfloat16* src = in ? x + row_x[buf][r] + v * CI + swz<C::NC>(row, pc) * 8 : x;
      cp_async16(xs + i * 16, src, in ? 16 : 0);
    }
    for (int i = tid; i < C::TR * 4 * TC_TX * C::NCG; i += TDW_THREADS) {
      // row (r * 4 + slice) * 16 + v: voxel v's 2 Co elements of the span
      const int row = i / C::NCG, pc = i % C::NCG, span = row / TC_TX, v = row % TC_TX;
      const int r = span >> 2, sl = span & 3;
      const bool in = v < row_n[buf][r];
      const long off = row_g[buf][r] + (long)((sl >> 1) * 2 * H + (sl & 1)) * 2 * W * CO;
      const __nv_bfloat16* src = in ? g + off + v * C::SN + swz<C::NCG>(row, pc) * 8 : g;
      cp_async16(gs + i * 16, src, in ? 16 : 0);
    }
  };

  float acc[C::MTW][2 * C::NQ][4];
#pragma unroll
  for (int j = 0; j < C::MTW; ++j)
#pragma unroll
    for (int nt = 0; nt < 2 * C::NQ; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][nt][k] = 0.0f;

  int buf = 0;
  if ((long)blockIdx.x < ntiles) stage(blockIdx.x, 0);
  cp_async_commit();
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed (the next one may fly)
    __syncthreads();
    const uint32_t x_u32 = smem_u32(smem + buf * C::STAGE_BYTES), g_u32 = x_u32 + C::X_BYTES;
#pragma unroll 2
    for (int r = 0; r < C::TR; ++r) {
      uint32_t a[C::MTW][4], b[C::NQ][4];
#pragma unroll
      for (int j = 0; j < C::MTW; ++j) {
        const int row = r * TC_TX + a_row;
        ldsm_x4_trans(a[j], x_u32 + row * CI * 2 + swz<C::NC>(row, (mt0 + j) * 2 + a_chunk) * 16);
      }
#pragma unroll
      for (int q = 0; q < C::NQ; ++q) {
        const int row = (r * 4 + s) * TC_TX + b_row;
        ldsm_x4_trans(b[q], g_u32 + row * C::SN * 2 + swz<C::NCG>(row, 2 * q + b_chunk) * 16);
      }
#pragma unroll
      for (int j = 0; j < C::MTW; ++j)
#pragma unroll
        for (int q = 0; q < C::NQ; ++q) {
          mma_bf16(acc[j][2 * q], a[j], b[q][0], b[q][1]);
          mma_bf16(acc[j][2 * q + 1], a[j], b[q][2], b[q][3]);
        }
    }
    __syncthreads();  // every warp is done with `buf` before it is staged again
  }

  // the block's partial: acc[j][nt] holds rows (gq, gq + 8) of m-tile mt0 +
  // j and columns 2t, 2t + 1 of n-tile nt of slice s, i.e. tap s * 2 + rx
  const int gq = lane >> 2, t = lane & 3;
  float* out = part + (long)blockIdx.x * 8 * CI * CO;
#pragma unroll
  for (int j = 0; j < C::MTW; ++j)
#pragma unroll
    for (int nt = 0; nt < 2 * C::NQ; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = (mt0 + j) * 16 + gq + 8 * h, n = nt * 8 + 2 * t;
        const int tap = s * 2 + n / CO, co = n % CO;
        *reinterpret_cast<float2*>(out + ((long)tap * CI + ci) * CO + co) =
            make_float2(acc[j][nt][2 * h], acc[j][nt][2 * h + 1]);
      }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int CI, int CO>
static void launch_trans(const void* x, const void* pa, const void* pb, int act, const void* w,
                         const void* bias, void* y, int D, int H, int W, cudaStream_t s) {
  using C = TransCfg<CI, CO>;
  const long nrows = (long)((W + TC_TX - 1) / TC_TX) * H * D;
  auto kernel = trans2x_tc_kernel<CI, CO>;
  const unsigned grid = grid_for(kernel, C::SMEM, (nrows + TC_WARPS - 1) / TC_WARPS, true);
  kernel<<<grid, TC_THREADS, C::SMEM, s>>>(
      (const __nv_bfloat16*)x, (const float*)pa, (const float*)pb, act,
      (const unsigned char*)w, (const float*)bias, (__nv_bfloat16*)y, D, H, W);
}

template <int CI, int CO>
static void launch_trans_dx(const void* g, const void* w, void* dx, int D, int H, int W,
                            cudaStream_t s) {
  using C = TransDxCfg<CI, CO>;
  const long nrows = (long)((W + TC_TX - 1) / TC_TX) * H * D;
  auto kernel = trans2x_dx_tc_kernel<CI, CO>;
  const unsigned grid = grid_for(kernel, C::SMEM, (nrows + TC_WARPS - 1) / TC_WARPS, true);
  kernel<<<grid, TC_THREADS, C::SMEM, s>>>((const __nv_bfloat16*)g, (const unsigned char*)w,
                                           (__nv_bfloat16*)dx, D, H, W);
}

template <int CI, int CO>
static void launch_trans_dw(const void* x, const void* g, int D, int H, int W, void* part,
                            int nblk, cudaStream_t s) {
  using C = TransDwCfg<CI, CO>;
  auto kernel = dw_trans_tc_kernel<CI, CO>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  kernel<<<(unsigned)nblk, TDW_THREADS, C::SMEM, s>>>((const __nv_bfloat16*)x,
                                                      (const __nv_bfloat16*)g, D, H, W,
                                                      (float*)part);
}

extern "C" int unet_dw_reduce(const void* part, int nblk, long n, void* out, void* stream);

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 on success),
// or cudaErrorInvalidValue for a channel pair it has no instance for.  The
// wrappers (ops/conv.py) have checked dtype (bf16), shapes, contiguity and
// 16-byte alignment, and packed w (ops/tc_layout.py).

// K4: x (D, H, W, ci) -> y (2D, 2H, 2W, co); w pack_weights(w, "k4")
int unet_trans2x_tc(const void* x, const void* pa, const void* pb, int act, int ci,
                    const void* w, const void* bias, void* y, int D, int H, int W, int co,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 32 && co == 16)
    launch_trans<32, 16>(x, pa, pb, act, w, bias, y, D, H, W, s);
  else if (ci == 64 && co == 32)
    launch_trans<64, 32>(x, pa, pb, act, w, bias, y, D, H, W, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K8: g (2D, 2H, 2W, co) -> dx (D, H, W, ci); w pack_weights(w, "k8")
int unet_trans2x_dx_tc(const void* g, int co, const void* w, void* dx, int D, int H, int W,
                       int ci, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 32 && co == 16)
    launch_trans_dx<32, 16>(g, w, dx, D, H, W, s);
  else if (ci == 64 && co == 32)
    launch_trans_dx<64, 32>(g, w, dx, D, H, W, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K9: x (D, H, W, ci), g (2D, 2H, 2W, co) -> dW (8, ci, co) f32 in out, tap
// (rz, ry, rx), through part: (nblk, 8, ci, co) f32 scratch
// (ops/tc_layout.py trans_dw_blocks)
int unet_trans2x_dw_tc(const void* x, const void* g, int D, int H, int W, int ci, int co,
                       void* part, int nblk, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 32 && co == 16)
    launch_trans_dw<32, 16>(x, g, D, H, W, part, nblk, s);
  else if (ci == 64 && co == 32)
    launch_trans_dw<64, 32>(x, g, D, H, W, part, nblk, s);
  else
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return unet_dw_reduce(part, nblk, 8L * ci * co, out, stream);
}

}  // extern "C"
