// bf16 tensor-core kernels of the 3^3 convolutions, channels-last
// (D, H, W, C), f32 accumulation: the route of every bf16 call of K1 (all
// four uses), K3, K5, K6 and K7 (those of the ks2 transposed conv, K4 and
// K9, are trans_tc.cu's).  f32 calls keep the FMA kernels of conv.cu and
// conv_bwd.cu (on the tensor cores f32 would mean TF32).  The PTX
// building blocks are tc.cuh's.
//
// K1 conv3_tc_kernel<CI, CO, NSRC, TZ> replaces
//    unet_studio_tpu/ops/pallas_conv.py:355 _fwd_kernel (conv3x3x3_s1, and
//    conv3x3x3_dx: the same conv of g with flipped, transposed weights,
//    ops/pallas_conv.py:766) and the two summed K1 calls of the decoder
//    entry, unet_studio_tpu/models/unet3d.py:812-819 (conv3x3x3_dual,
//    NSRC = 2).
// K1 entry_tc_kernel<CO> replaces unet_studio_tpu/ops/packed.py:736
//    conv_entry (Ci = 1).
// K3 s2_tc_kernel<CI, CO> replaces unet_studio_tpu/ops/packed.py:227
//    _s2_fwd_kernel (conv3x3x3_s2, C -> 2C at stride 2).
// K7 s2dx_tc_kernel<CI, CO> replaces unet_studio_tpu/ops/packed.py:1008
//    _s2_dx_kernel (conv3x3x3_s2_dx).
// K5 dw_tc_kernel<CI> and dw_entry_tc_kernel (Ci = 1) replace
//    unet_studio_tpu/ops/pallas_conv.py:583 _dw_kernel (conv3x3x3_dw), and
// K6 dw_s2_tc_kernel<CI> replaces unet_studio_tpu/ops/packed.py:897
//    _s2_dw_kernel (conv3x3x3_s2_dw); their design is described at the
//    kernels.
//
// The K1, K3 and K7 kernels are each an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 out):
//   - M is a tile of output voxels, 16 consecutive x per MMA row block;
//   - N is the output channels, all of them in one block (K3 at Co = 128:
//     one half of them per block, over grid.y);
//   - K is walked in k-steps of 16: (source, tap, 16-channel chunk) for
//     K1 and K3, (parity class, tap of the class, chunk) for K7, padded
//     27 -> 32 taps for the entry.
// The input's halo tile is copied once per tile into shared memory with
// cp.async (zero-filled outside the volume) and every tap reads a shifted
// view of it: A comes from shared memory through ldmatrix with one row
// address per lane, which is the im2col gather.  Rows are 16-byte chunks
// XOR-swizzled by voxel, so the 8 rows of an ldmatrix phase (8
// consecutive voxels, whatever the tap's shift) hit 8 distinct bank
// groups.  The weights come pre-packed by the wrapper (ops/tc_layout.py)
// in mma B-fragment order, one 16-byte shared load per lane for two
// n-tiles; they stay resident in shared memory when they fit in 32 KB
// (the block then walks tiles persistently and loads them once), else
// they stream through a 3-deep cp.async ring, one tap per stage, so the
// next tap's weights load while this tap's MMAs run.  With resident
// weights K1 walks the taps so that a warp's A fragments serve three
// taps each (its rows are consecutive y, and row y at tap dy reads the
// halo row of row y + 1 at tap dy - 1): at C = 16, two MMAs per
// fragment, shared-memory bandwidth is what bounds the MMA loop.
//
// Why mma.sync and not wgmma: a tap's A operand starts one voxel (16-128
// bytes) past another's, which wgmma's swizzled shared-memory layouts do
// not take, and level 0 (C = 16, 216 op/byte, under the card's 295
// op/byte ridge) is bound by bytes, not by the MMA rate.
//
// Prologue (deferred instance norm of the previous layer): act(a*x + b)
// in f32, multiply and add rounded apart, rounded to bf16, applied once
// per staged element in shared memory after the tile lands (cp.async's
// zero fill comes before it, so the pass skips positions outside the
// volume, which stay exactly 0); each thread keeps one 8-channel chunk's
// a and b in registers.  Epilogue: bias added to the f32
// accumulator; the stats (sum y, sum y^2 per channel) from the f32
// accumulator before the cast, rows past the ragged edge left out,
// folded over lanes with shuffles, then into one running row per warp in
// shared memory over the block's tiles in tile order, then over the warps
// in warp order into the block's row of a (blocks, 2, Co) partial buffer,
// whose rows a second launch (unet_dw_reduce, conv_bwd.cu) adds in order:
// no atomics, so the stats are bitwise the same from run to run; bf16
// staged in shared memory and stored as 16-byte coalesced rows.
//
// What bounds them on the H100 (bf16, each input read once, each output
// written once): level-0 K1 16->16 moves 528 MB for 114 GFLOP (0.158 ms
// at 3.35 TB/s, bytes); K3 16->32 and K7 32->16 330 MB for 28.5 GFLOP
// (0.099 ms, bytes); K3 64->128 at level 2 20.6 MB for 7.1 GFLOP (0.0072
// ms at the bf16 tensor-core peak, operations).

#include "tc.cuh"

#define RING 3  // weight ring depth when the weights do not fit
#define RESIDENT_BYTES (32 * 1024)

// ---------------------------------------------------------------------------
// shared epilogue of the K1 and K3 kernels: bias, stats, bf16 through
// shared memory
// ---------------------------------------------------------------------------

// acc[mt][nt][4] of MT row blocks per warp over the block's NB output
// channels n0 .. n0 + NB - 1 of CO; row block r = warp * MT + mt is the
// output row (z0 + r / TY, y0 + r % TY, x0 .. x0 + 15).  bias holds the
// block's NB channels.  `stage` holds the tile's bf16 result (TZ * TY * 16
// voxels, rows of NB * 2 + 16 bytes).  red[warp][2][NB]: each warp's
// running stats over the block's tiles, added in tile order; one lane
// owns each (warp, channel), so no atomics.
template <int NB, int MT, int TY>
__device__ __forceinline__ void tc_epilogue(float (*acc)[NB / 8][4], const float* bias,
                                            float* red, unsigned char* stage,
                                            __nv_bfloat16* __restrict__ y, int co, int n0,
                                            int z0, int y0, int x0, int D, int H, int W,
                                            bool want_stats) {
  constexpr int SROW = NB * 2 + 16;
  constexpr int M = TC_WARPS * MT * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NB / 8; ++nt) {
    const float b0 = bias[nt * 8 + 2 * t], b1 = bias[nt * 8 + 2 * t + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][nt][0] += b0;
      acc[mt][nt][1] += b1;
      acc[mt][nt][2] += b0;
      acc[mt][nt][3] += b1;
    }
  }
  if (want_stats) {
    float* wred = red + warp * 2 * NB;
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = warp * MT + mt;
        const bool row_ok = z0 + r / TY < D && y0 + r % TY < H;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row_ok && x0 + g + 8 * h < W) {
            const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
            s0 += v0;
            s1 += v1;
            q0 += v0 * v0;
            q1 += v1 * v1;
          }
        }
      }
      // butterfly over the 8 lanes of one t: each ends with the same bits
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        q1 += __shfl_xor_sync(0xffffffffu, q1, off);
      }
      if (g == 0) {
        wred[nt * 8 + 2 * t] += s0;
        wred[nt * 8 + 2 * t + 1] += s1;
        wred[NB + nt * 8 + 2 * t] += q0;
        wred[NB + nt * 8 + 2 * t + 1] += q1;
      }
    }
  }
  __syncthreads();  // every warp is done reading the halo that `stage` reuses
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (warp * MT + mt) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      const int col = (nt * 8 + 2 * t) * 2;
      *reinterpret_cast<__nv_bfloat162*>(stage + m * SROW + col) =
          __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(stage + (m + 8) * SROW + col) =
          __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * (NB / 8); i += TC_THREADS) {
    const int m = i / (NB / 8), c = i % (NB / 8);
    const int r = m / 16, gx = x0 + m % 16, gy = y0 + r % TY, gz = z0 + r / TY;
    if (gz < D && gy < H && gx < W)
      *reinterpret_cast<uint4*>(y + (((long)gz * H + gy) * W + gx) * co + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(stage + m * SROW + c * 16);
  }
  __syncthreads();  // `stage` is free for the next tile's halo
}

// The block's stats partial: row[r * co + n0 + j] = the warps' sums of
// red[.][r][j], added in warp order.
template <int NB>
__device__ __forceinline__ void flush_stats(const float* red, float* row, int co, int n0) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * NB; i += TC_THREADS) {
    float s = red[i];
#pragma unroll
    for (int w = 1; w < TC_WARPS; ++w) s += red[w * 2 * NB + i];
    row[(i / NB) * co + n0 + i % NB] = s;
  }
}

// ---------------------------------------------------------------------------
// K1: C->C (NSRC = 1) and 2C->C (NSRC = 2), stride 1, pad 1
// ---------------------------------------------------------------------------

template <int CI, int CO, int NSRC, int TZ>
struct K1Cfg {
  static constexpr int TY = 8;
  static constexpr int MT = TZ * TY / 4;  // row blocks per warp
  static constexpr int HZ = TZ + 2, HY = TY + 2, HX = TC_TX + 2;
  static constexpr int HV = HZ * HY * HX;
  static constexpr int NC = CI / 8;  // 16-byte chunks per voxel
  static constexpr int HALO_BYTES = HV * CI * 2;
  static constexpr int CK = CI / 16;  // k-steps per tap
  static constexpr int KSTEP_BYTES = CO * 32;
  static constexpr int KSTEPS = NSRC * 27 * CK;
  static constexpr int W_BYTES = KSTEPS * KSTEP_BYTES;
  static constexpr bool RESIDENT = W_BYTES <= RESIDENT_BYTES;
  static constexpr int KPS = RESIDENT ? KSTEPS : CK;  // k-steps per stage
  static constexpr int NSTAGE = KSTEPS / KPS;
  static constexpr int STAGE_BYTES = KPS * KSTEP_BYTES;
  static constexpr int NBUF = RESIDENT ? 1 : RING;
  static constexpr int SMEM = NSRC * HALO_BYTES + NBUF * STAGE_BYTES;
  static_assert(4 * MT * 16 * (CO * 2 + 16) <= HALO_BYTES, "output staging exceeds the halo");
  static_assert(TC_THREADS % NC == 0, "a thread keeps one channel chunk in the prologue");
  static_assert(TY % MT == 0, "a warp's rows lie in one z plane");
  static_assert((TC_THREADS / NC) % 8 == 0, "a thread's chunks keep one swizzle");
};

template <int CI, int CO, int NSRC, int TZ>
__global__ void __launch_bounds__(TC_THREADS)
conv3_tc_kernel(const __nv_bfloat16* __restrict__ xa, const float* __restrict__ pa_a,
                const float* __restrict__ pb_a, int act_a, const __nv_bfloat16* __restrict__ xb,
                const float* __restrict__ pa_b, const float* __restrict__ pb_b, int act_b,
                const unsigned char* __restrict__ wpk, const float* __restrict__ bias_g,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part, int D, int H, int W) {
  using C = K1Cfg<CI, CO, NSRC, TZ>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* halo = smem;                          // NSRC halos
  unsigned char* wbuf = smem + NSRC * C::HALO_BYTES;  // weight stages
  __shared__ float pro[NSRC][2][CI];
  __shared__ float bias[CO];
  __shared__ float red[TC_WARPS * 2 * CO];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < NSRC * CI; i += TC_THREADS) {
    const int s = i / CI, c = i % CI;
    const float* pa = s ? pa_b : pa_a;
    const float* pb = s ? pb_b : pb_a;
    pro[s][0][c] = pa != nullptr ? pa[c] : 1.0f;
    pro[s][1][c] = pa != nullptr ? pb[c] : 0.0f;
  }
  for (int i = threadIdx.x; i < CO; i += TC_THREADS) bias[i] = bias_g[i];
  for (int i = threadIdx.x; i < TC_WARPS * 2 * CO; i += TC_THREADS) red[i] = 0.0f;

  const int ntx = (W + TC_TX - 1) / TC_TX, nty = (H + C::TY - 1) / C::TY;
  const int ntz = (D + TZ - 1) / TZ;
  const long ntiles = (long)ntx * nty * ntz;
  bool w_loaded = false;
  const uint32_t halo_u32 = smem_u32(halo);
  int vrow[C::MT];  // halo voxel of this lane's A row at tap (0, 0, 0)
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    const int r = warp * C::MT + mt;
    vrow[mt] = ((r / C::TY) * C::HY + r % C::TY) * C::HX + (lane & 15);
  }

  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int x0 = (int)(tile % ntx) * TC_TX;
    const int y0 = (int)((tile / ntx) % nty) * C::TY;
    const int z0 = (int)(tile / ((long)ntx * nty)) * TZ;
    const bool interior = x0 >= 1 && x0 + TC_TX < W && y0 >= 1 && y0 + C::TY < H && z0 >= 1 &&
                          z0 + TZ < D;

    // halo tiles of every source (zero outside the volume), with the
    // first weight stages, as the first cp.async groups
    for (int s = 0; s < NSRC; ++s) {
      const __nv_bfloat16* x = s ? xb : xa;
      unsigned char* hs = halo + s * C::HALO_BYTES;
      for (int i = threadIdx.x; i < C::HV * C::NC; i += TC_THREADS) {
        const int v = i / C::NC, pc = i % C::NC, c = swz<C::NC>(v, pc);
        const int hx = v % C::HX, hy = (v / C::HX) % C::HY, hz = v / (C::HX * C::HY);
        const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
        const bool in = gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 && gz < D;
        const __nv_bfloat16* src = in ? x + (((long)gz * H + gy) * W + gx) * CI + c * 8 : x;
        cp_async16(hs + v * CI * 2 + pc * 16, src, in ? 16 : 0);
      }
    }
    if constexpr (C::RESIDENT) {
      if (!w_loaded) copy_async(wbuf, wpk, C::STAGE_BYTES);
      w_loaded = true;
      cp_async_commit();
    } else {
#pragma unroll
      for (int st = 0; st < RING - 1; ++st) {
        if (st < C::NSTAGE)
          copy_async(wbuf + st * C::STAGE_BYTES, wpk + (long)st * C::STAGE_BYTES,
                     C::STAGE_BYTES);
        cp_async_commit();
      }
    }

    float acc[C::MT][CO / 8][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

#pragma unroll 1
    for (int st = 0; st < C::NSTAGE; ++st) {
      if constexpr (C::RESIDENT)
        cp_async_wait<0>();
      else
        cp_async_wait<RING - 2>();
      __syncthreads();  // stage st has landed; every warp is done with st - 1
      if (st == 0) {
        // the prologue, once per staged element, positions outside the
        // volume left at 0
        for (int s = 0; s < NSRC; ++s) {
          if ((s ? pa_b : pa_a) == nullptr) continue;
          const int act = s ? act_b : act_a;
          unsigned char* hs = halo + s * C::HALO_BYTES;
          // a thread always takes the same 8 channels (logical chunk c), so
          // their a and b stay in registers
          const int c = threadIdx.x % C::NC;
          float fa[8], fb[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            fa[k] = pro[s][0][c * 8 + k];
            fb[k] = pro[s][1][c * 8 + k];
          }
          auto apply = [&](unsigned char* q) { prologue_chunk(q, fa, fb, act); };
          constexpr int VSTEP = TC_THREADS / C::NC;  // voxels between a thread's chunks
          if (interior) {
            // the whole halo lies in the volume, and the thread's chunk has
            // the same swizzle in every voxel it takes (VSTEP keeps v's
            // swizzle bits): a fixed stride through shared memory
            const int v0 = threadIdx.x / C::NC;
            unsigned char* q = hs + v0 * CI * 2 + swz<C::NC>(v0, c) * 16;
            for (int v = v0; v < C::HV; v += VSTEP, q += VSTEP * CI * 2) apply(q);
          } else {
            for (int v = threadIdx.x / C::NC; v < C::HV; v += VSTEP) {
              const int hx = v % C::HX, hy = (v / C::HX) % C::HY, hz = v / (C::HX * C::HY);
              const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
              if (gx < 0 || gx >= W || gy < 0 || gy >= H || gz < 0 || gz >= D) continue;
              apply(hs + v * CI * 2 + swz<C::NC>(v, c) * 16);
            }
          }
        }
        __syncthreads();
      }
      if constexpr (!C::RESIDENT) {
        const int nx = st + RING - 1;
        if (nx < C::NSTAGE)
          copy_async(wbuf + (nx % RING) * C::STAGE_BYTES, wpk + (long)nx * C::STAGE_BYTES,
                     C::STAGE_BYTES);
        cp_async_commit();
      }
      if constexpr (C::RESIDENT) {
        // Every weight is in shared memory, so the taps go in the order
        // that shares A: the warp's MT rows are consecutive y at one z, and
        // row mt at tap dy reads the halo row that row mt + 1 reads at dy -
        // 1.  Per (source, dz, dx, chunk) the warp loads MT + 2 A fragments
        // and the 3 dy taps' B, and runs 3 * MT * CO / 8 MMAs on them: half
        // the ldmatrix traffic of one fragment per row and tap.
#pragma unroll
        for (int s = 0; s < NSRC; ++s)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int chunk = 0; chunk < C::CK; ++chunk) {
                uint32_t a[C::MT + 2][4], b[3][CO / 8][2];
                const uint32_t hs = halo_u32 + s * C::HALO_BYTES;
#pragma unroll
                for (int j = 0; j < C::MT + 2; ++j) {
                  const int v = vrow[0] + (dz * C::HY + j) * C::HX + dx;
                  ldsm_x4(a[j], hs + v * CI * 2 + swz<C::NC>(v, chunk * 2 + (lane >> 4)) * 16);
                }
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
                  load_b<CO>(b[dy],
                             wbuf + ((s * 27 + dz * 9 + dy * 3 + dx) * C::CK + chunk) *
                                        C::KSTEP_BYTES,
                             lane);
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < CO / 8; ++nt)
                      mma_bf16(acc[mt][nt], a[mt + dy], b[dy][nt][0], b[dy][nt][1]);
              }
      } else {
        // one tap per stage: its k-steps, unrolled, with the next k-step's
        // fragments loaded before this one's MMAs
        const unsigned char* ws = wbuf + (st % RING) * C::STAGE_BYTES;
        uint32_t a[2][C::MT][4], b[2][CO / 8][2];
        auto load = [&](int buf, int kk) {
          const int ks = st * C::KPS + kk;
          const int chunk = ks % C::CK, tap = (ks / C::CK) % 27, s = ks / (27 * C::CK);
          const int off = ((tap / 9) * C::HY + (tap / 3) % 3) * C::HX + tap % 3;
          load_b<CO>(b[buf], ws + kk * C::KSTEP_BYTES, lane);
          const uint32_t hs = halo_u32 + s * C::HALO_BYTES;
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            const int v = vrow[mt] + off;
            ldsm_x4(a[buf][mt], hs + v * CI * 2 + swz<C::NC>(v, chunk * 2 + (lane >> 4)) * 16);
          }
        };
        load(0, 0);
#pragma unroll
        for (int kk = 0; kk < C::KPS; ++kk) {
          if (kk + 1 < C::KPS) load((kk + 1) & 1, kk + 1);
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < CO / 8; ++nt)
              mma_bf16(acc[mt][nt], a[kk & 1][mt], b[kk & 1][nt][0], b[kk & 1][nt][1]);
        }
      }
    }
    tc_epilogue<CO, C::MT, C::TY>(acc, bias, red, halo, y, CO, 0, z0, y0, x0, D, H, W,
                                   part != nullptr);
  }
  if (part != nullptr) flush_stats<CO>(red, part + (long)blockIdx.x * 2 * CO, CO, 0);
}

// ---------------------------------------------------------------------------
// K1 entry: 1 -> CO, K = 27 taps padded to 32
// ---------------------------------------------------------------------------

template <int CO>
struct EntryCfg {
  static constexpr int TZ = 2, TY = 8, MT = 4;
  static constexpr int HZ = TZ + 2, HY = TY + 2, HX = TC_TX + 2;
  static constexpr int HV = HZ * HY * HX;
  static constexpr int M = TZ * TY * TC_TX;
  static constexpr int A_BYTES = M * 64;  // 32 bf16 taps per output voxel
  static constexpr int W_BYTES = 2 * CO * 32;
  static constexpr int STAGE_BYTES = M * (CO * 2 + 16);
  static constexpr int A_REGION = A_BYTES > STAGE_BYTES ? A_BYTES : STAGE_BYTES;
  static constexpr int SMEM = A_REGION + W_BYTES + ((HV * 2 + 15) / 16) * 16;
};

template <int CO>
__global__ void __launch_bounds__(TC_THREADS)
entry_tc_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ wpk,
                const float* __restrict__ bias_g, __nv_bfloat16* __restrict__ y,
                float* __restrict__ part, int D, int H, int W) {
  using C = EntryCfg<CO>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* abuf = smem;  // im2col rows, then the output staging
  unsigned char* wbuf = smem + C::A_REGION;
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(wbuf + C::W_BYTES);
  __shared__ float bias[CO];
  __shared__ float red[TC_WARPS * 2 * CO];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < CO; i += TC_THREADS) bias[i] = bias_g[i];
  for (int i = threadIdx.x; i < TC_WARPS * 2 * CO; i += TC_THREADS) red[i] = 0.0f;
  copy_async(wbuf, wpk, C::W_BYTES);
  cp_async_commit();

  const int ntx = (W + TC_TX - 1) / TC_TX, nty = (H + C::TY - 1) / C::TY;
  const int ntz = (D + C::TZ - 1) / C::TZ;
  const long ntiles = (long)ntx * nty * ntz;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  unsigned short* hs = reinterpret_cast<unsigned short*>(hbuf);
  static_assert(TC_THREADS % 4 == 0, "a thread builds one im2col chunk");
  const int c = threadIdx.x % 4;
  int tap_off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int tap = c * 8 + k;
    tap_off[k] = tap < 27 ? ((tap / 9) * C::HY + (tap / 3) % 3) * C::HX + tap % 3 : -1;
  }

  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int x0 = (int)(tile % ntx) * TC_TX;
    const int y0 = (int)((tile / ntx) % nty) * C::TY;
    const int z0 = (int)(tile / ((long)ntx * nty)) * C::TZ;
    // the one-channel halo, 2-byte loads (its rows need not be 16-byte
    // aligned), 0 outside the volume
    for (int v = threadIdx.x; v < C::HV; v += TC_THREADS) {
      const int hx = v % C::HX, hy = (v / C::HX) % C::HY, hz = v / (C::HX * C::HY);
      const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
      const bool in = gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 && gz < D;
      hs[v] = in ? xs[((long)gz * H + gy) * W + gx] : (unsigned short)0;
    }
    __syncthreads();
    // im2col: row m holds the 27 taps of output voxel m and 5 zeros, as
    // four swizzled 16-byte chunks of 8 taps; a thread always builds chunk
    // c = threadIdx.x % 4, whose halo offsets it keeps (-1: a padding tap)
    for (int i = threadIdx.x; i < C::M * 4; i += TC_THREADS) {
      const int m = i / 4;
      const int r = m / 16, row = ((r / C::TY) * C::HY + r % C::TY) * C::HX + m % 16;
      __align__(16) unsigned short v8[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v8[k] = tap_off[k] < 0 ? 0 : hs[row + tap_off[k]];
      *reinterpret_cast<uint4*>(abuf + m * 64 + swz<4>(m, c) * 16) =
          *reinterpret_cast<const uint4*>(v8);
    }
    cp_async_wait<0>();
    __syncthreads();

    float acc[C::MT][CO / 8][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t b[CO / 8][2];
      load_b<CO>(b, wbuf + ks * CO * 32, lane);
      const int kc = ks * 2 + (lane >> 4);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const int m = (warp * C::MT + mt) * 16 + (lane & 15);
        uint32_t a[4];
        ldsm_x4(a, smem_u32(abuf + m * 64 + swz<4>(m, kc) * 16));
#pragma unroll
        for (int nt = 0; nt < CO / 8; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    tc_epilogue<CO, C::MT, C::TY>(acc, bias, red, abuf, y, CO, 0, z0, y0, x0, D, H, W,
                                   part != nullptr);
  }
  if (part != nullptr) flush_stats<CO>(red, part + (long)blockIdx.x * 2 * CO, CO, 0);
}

// ---------------------------------------------------------------------------
// K3: C -> 2C, stride 2, pad 1, on even D, H, W
// ---------------------------------------------------------------------------
//
// The implicit GEMM of K1 on an output tile of TZ x TY x 16 voxels: M =
// 16 consecutive output x per row block, N = the block's NB output
// channels (Co = 128 is split into two halves of 64 over grid.y, each
// with its own packed weights), K = (tap, 16-channel chunk).  The input
// halo of the tile is (2TZ+1) x (2TY+1) x 33 voxels.  A tap's 16 A rows
// lie two input voxels apart, which would put the 8 rows of an ldmatrix
// phase on 4 bank groups; so each halo row is staged split by x parity
// (s2_slot): slots 0-15 hold the even input x = 2(x0 + j), slots 16-32 the
// odd x = 2(x0 + j) - 1.  Output x0 + m then reads slot m at tap dx = 1,
// slot 16 + m at dx = 0 and 17 + m at dx = 2: 16 consecutive slots, one
// row address per lane, and K1's voxel swizzle keeps every phase on 8
// bank groups.  The prologue and the epilogue are K1's.

// Halo slot of tap dx for output x offset m = 0 (add m)
__device__ __forceinline__ int s2_slot(int dx) { return dx == 1 ? 0 : 16 + dx / 2; }

template <int CI, int CO>
struct K3Cfg {
  static constexpr int NB = CO > 64 ? 64 : CO;  // output channels per block
  static constexpr int TZ = CI == 64 ? 1 : 2, TY = 4;
  static constexpr int MT = TZ * TY / TC_WARPS;  // row blocks per warp
  static constexpr int HZ = 2 * TZ + 1, HY = 2 * TY + 1, HX = 2 * TC_TX + 1;
  static constexpr int HV = HZ * HY * HX;
  static constexpr int NC = CI / 8;
  static constexpr int HALO_BYTES = HV * CI * 2;
  static constexpr int CK = CI / 16;
  static constexpr int KSTEP_BYTES = NB * 32;
  static constexpr int KSTEPS = 27 * CK;
  static constexpr int W_BYTES = KSTEPS * KSTEP_BYTES;  // one channel slice's weights
  static constexpr bool RESIDENT = W_BYTES <= RESIDENT_BYTES;
  static constexpr int KPS = RESIDENT ? KSTEPS : CK;  // k-steps per stage
  static constexpr int NSTAGE = KSTEPS / KPS;
  static constexpr int STAGE_BYTES = KPS * KSTEP_BYTES;
  static constexpr int NBUF = RESIDENT ? 1 : RING;
  static constexpr int SMEM = HALO_BYTES + NBUF * STAGE_BYTES;
  static_assert(TC_WARPS * MT * 16 * (NB * 2 + 16) <= HALO_BYTES,
                "output staging exceeds the halo");
  static_assert(MT * TC_WARPS == TZ * TY && TY % MT == 0, "a warp's rows lie in one z plane");
  static_assert((TC_THREADS / NC) % 8 == 0, "a thread's chunks keep one swizzle");
};

// Input coordinates of halo voxel v of the tile at output (z0, y0, x0)
template <int HY>
__device__ __forceinline__ void s2_halo_xyz(int v, int x0, int y0, int z0, int& gx, int& gy,
                                            int& gz) {
  constexpr int HX = 2 * TC_TX + 1;
  const int sl = v % HX, hy = (v / HX) % HY, hz = v / (HX * HY);
  gx = sl < TC_TX ? 2 * (x0 + sl) : 2 * (x0 + sl - TC_TX) - 1;
  gy = 2 * y0 - 1 + hy;
  gz = 2 * z0 - 1 + hz;
}

template <int CI, int CO>
__global__ void __launch_bounds__(TC_THREADS)
s2_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ pa,
             const float* __restrict__ pb, int act, const unsigned char* __restrict__ wpk,
             const float* __restrict__ bias_g, __nv_bfloat16* __restrict__ y,
             float* __restrict__ part, int D, int H, int W) {
  using C = K3Cfg<CI, CO>;
  constexpr int NB = C::NB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* halo = smem;
  unsigned char* wbuf = smem + C::HALO_BYTES;
  __shared__ float pro[2][CI];
  __shared__ float bias[NB];
  __shared__ float red[TC_WARPS * 2 * NB];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.y * NB;
  const unsigned char* wsl = wpk + (long)blockIdx.y * C::W_BYTES;  // this slice's weights
  for (int i = threadIdx.x; i < CI; i += TC_THREADS) {
    pro[0][i] = pa != nullptr ? pa[i] : 1.0f;
    pro[1][i] = pa != nullptr ? pb[i] : 0.0f;
  }
  for (int i = threadIdx.x; i < NB; i += TC_THREADS) bias[i] = bias_g[n0 + i];
  for (int i = threadIdx.x; i < TC_WARPS * 2 * NB; i += TC_THREADS) red[i] = 0.0f;

  const int OD = D / 2, OH = H / 2, OW = W / 2;
  const int ntx = (OW + TC_TX - 1) / TC_TX, nty = (OH + C::TY - 1) / C::TY;
  const int ntz = (OD + C::TZ - 1) / C::TZ;
  const long ntiles = (long)ntx * nty * ntz;
  bool w_loaded = false;
  const uint32_t halo_u32 = smem_u32(halo);
  int vrow[C::MT];  // halo voxel of this lane's A row at tap (0, 0, 1)
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    const int r = warp * C::MT + mt;
    vrow[mt] = ((2 * (r / C::TY)) * C::HY + 2 * (r % C::TY)) * C::HX + (lane & 15);
  }

  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int x0 = (int)(tile % ntx) * TC_TX;
    const int y0 = (int)((tile / ntx) % nty) * C::TY;
    const int z0 = (int)(tile / ((long)ntx * nty)) * C::TZ;
    const bool interior = x0 >= 1 && 2 * x0 + 2 * TC_TX <= W && y0 >= 1 &&
                          2 * y0 + 2 * C::TY <= H && z0 >= 1 && 2 * z0 + 2 * C::TZ <= D;

    for (int i = threadIdx.x; i < C::HV * C::NC; i += TC_THREADS) {
      const int v = i / C::NC, pc = i % C::NC, c = swz<C::NC>(v, pc);
      int gx, gy, gz;
      s2_halo_xyz<C::HY>(v, x0, y0, z0, gx, gy, gz);
      const bool in = gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 && gz < D;
      const __nv_bfloat16* src = in ? x + (((long)gz * H + gy) * W + gx) * CI + c * 8 : x;
      cp_async16(halo + v * CI * 2 + pc * 16, src, in ? 16 : 0);
    }
    if constexpr (C::RESIDENT) {
      if (!w_loaded) copy_async(wbuf, wsl, C::STAGE_BYTES);
      w_loaded = true;
      cp_async_commit();
    } else {
#pragma unroll
      for (int st = 0; st < RING - 1; ++st) {
        if (st < C::NSTAGE)
          copy_async(wbuf + st * C::STAGE_BYTES, wsl + (long)st * C::STAGE_BYTES,
                     C::STAGE_BYTES);
        cp_async_commit();
      }
    }

    float acc[C::MT][NB / 8][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NB / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

#pragma unroll 1
    for (int st = 0; st < C::NSTAGE; ++st) {
      if constexpr (C::RESIDENT)
        cp_async_wait<0>();
      else
        cp_async_wait<RING - 2>();
      __syncthreads();  // stage st has landed; every warp is done with st - 1
      if (st == 0 && pa != nullptr) {
        // the prologue, once per staged element, positions outside the
        // volume left at 0; a thread keeps one 8-channel chunk's a and b
        const int c = threadIdx.x % C::NC;
        float fa[8], fb[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          fa[k] = pro[0][c * 8 + k];
          fb[k] = pro[1][c * 8 + k];
        }
        auto apply = [&](unsigned char* q) { prologue_chunk(q, fa, fb, act); };
        constexpr int VSTEP = TC_THREADS / C::NC;
        if (interior) {
          const int v0 = threadIdx.x / C::NC;
          unsigned char* q = halo + v0 * CI * 2 + swz<C::NC>(v0, c) * 16;
          for (int v = v0; v < C::HV; v += VSTEP, q += VSTEP * CI * 2) apply(q);
        } else {
          for (int v = threadIdx.x / C::NC; v < C::HV; v += VSTEP) {
            int gx, gy, gz;
            s2_halo_xyz<C::HY>(v, x0, y0, z0, gx, gy, gz);
            if (gx < 0 || gx >= W || gy < 0 || gy >= H || gz < 0 || gz >= D) continue;
            apply(halo + v * CI * 2 + swz<C::NC>(v, c) * 16);
          }
        }
        __syncthreads();
      }
      if constexpr (!C::RESIDENT) {
        const int nx = st + RING - 1;
        if (nx < C::NSTAGE)
          copy_async(wbuf + (nx % RING) * C::STAGE_BYTES, wsl + (long)nx * C::STAGE_BYTES,
                     C::STAGE_BYTES);
        cp_async_commit();
      }
      // the stage's k-steps, unrolled, the next k-step's fragments loaded
      // before this one's MMAs
      const unsigned char* ws = wbuf + (C::RESIDENT ? 0 : (st % RING) * C::STAGE_BYTES);
      uint32_t a[2][C::MT][4], b[2][NB / 8][2];
      auto load = [&](int buf, int kk) {
        const int ks = st * C::KPS + kk;
        const int chunk = ks % C::CK, tap = ks / C::CK;
        const int off = ((tap / 9) * C::HY + (tap / 3) % 3) * C::HX + s2_slot(tap % 3);
        load_b<NB>(b[buf], ws + kk * C::KSTEP_BYTES, lane);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          const int v = vrow[mt] + off;
          ldsm_x4(a[buf][mt], halo_u32 + v * CI * 2 + swz<C::NC>(v, chunk * 2 + (lane >> 4)) * 16);
        }
      };
      load(0, 0);
#pragma unroll
      for (int kk = 0; kk < C::KPS; ++kk) {
        if (kk + 1 < C::KPS) load((kk + 1) & 1, kk + 1);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NB / 8; ++nt)
            mma_bf16(acc[mt][nt], a[kk & 1][mt], b[kk & 1][nt][0], b[kk & 1][nt][1]);
      }
    }
    tc_epilogue<NB, C::MT, C::TY>(acc, bias, red, halo, y, CO, n0, z0, y0, x0, OD, OH, OW,
                                  part != nullptr);
  }
  if (part != nullptr) flush_stats<NB>(red, part + (long)blockIdx.x * 2 * CO, CO, n0);
}

// ---------------------------------------------------------------------------
// K7: input gradient of the 3^3 stride-2 pad-1 conv, g (OD, OH, OW, CO) ->
// dx (2OD, 2OH, 2OW, CI), as 8 parity-class GEMMs per tile of g
// ---------------------------------------------------------------------------
//
// Per axis, dx[2q] takes tap 1 of g[q]; dx[2q+1] takes tap 2 of g[q] and
// tap 0 of g[q+1] (g past the end reads 0).  Class p = (pz, py, px) (bit 2
// z, bit 0 x) takes the product of its axes' lists, z outermost, each
// axis's list in the order (offset 0, tap 2), (offset 1, tap 0) when odd:
// 1, 2, 2, 4, 2, 4, 4, 8 taps for p = 0..7, 27 in all, each used once.
// The wrapper packs the weights in that tap order (ops/tc_layout.py
// s2dx_taps).  A block stages one g tile with its +1 halo on the high
// side once, runs the 8 classes on it, interleaves their results in
// shared memory and stores the 2x-size dx tile as contiguous rows.

template <int CI, int CO>
struct S2Cfg {
  static constexpr int TZ = 1, TY = 4;  // q tile: 1 x 4 x 16, one row block per warp
  static constexpr int HZ = TZ + 1, HY = TY + 1, HX = TC_TX + 1;
  static constexpr int HV = HZ * HY * HX;
  static constexpr int NC = CO / 8;
  static constexpr int HALO_BYTES = ((HV * CO * 2 + 127) / 128) * 128;
  static constexpr int CK = CO / 16;
  static constexpr int G = CK < 4 ? CK : 4;  // chunks whose fragments load together
  static constexpr int KSTEP_BYTES = CI * 32;
  static constexpr int KSTEPS = 27 * CK;
  static constexpr int W_BYTES = KSTEPS * KSTEP_BYTES;
  static constexpr bool RESIDENT = W_BYTES <= RESIDENT_BYTES;
  static constexpr int STAGE_BYTES = RESIDENT ? W_BYTES : CK * KSTEP_BYTES;  // all, or one tap
  static constexpr int NBUF = RESIDENT ? 1 : RING;
  static constexpr int DZ = 2 * TZ, DY = 2 * TY, DX = 2 * TC_TX;  // dx tile
  static constexpr int SROW = CI * 2 + 16;
  static constexpr int OUT_BYTES = DZ * DY * DX * SROW;
  static constexpr int SMEM = HALO_BYTES + NBUF * STAGE_BYTES + OUT_BYTES;
};

template <int CI, int CO>
__global__ void __launch_bounds__(TC_THREADS)
s2dx_tc_kernel(const __nv_bfloat16* __restrict__ g, const unsigned char* __restrict__ wpk,
               __nv_bfloat16* __restrict__ dx, int OD, int OH, int OW) {
  using C = S2Cfg<CI, CO>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* halo = smem;
  unsigned char* wbuf = smem + C::HALO_BYTES;
  unsigned char* outb = wbuf + C::NBUF * C::STAGE_BYTES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int ntx = (OW + TC_TX - 1) / TC_TX, nty = (OH + C::TY - 1) / C::TY;
  const int ntz = (OD + C::TZ - 1) / C::TZ;
  const long ntiles = (long)ntx * nty * ntz;
  const int D = 2 * OD, H = 2 * OH, W = 2 * OW;
  // this warp's row block: q row (z0, y0 + warp), x0 .. x0 + 15
  const int zz = 0, yy = warp;
  bool w_loaded = false;
  const uint32_t halo_u32 = smem_u32(halo);

  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int x0 = (int)(tile % ntx) * TC_TX;
    const int y0 = (int)((tile / ntx) % nty) * C::TY;
    const int z0 = (int)(tile / ((long)ntx * nty)) * C::TZ;
    for (int i = threadIdx.x; i < C::HV * C::NC; i += TC_THREADS) {
      const int v = i / C::NC, pc = i % C::NC, c = swz<C::NC>(v, pc);
      const int hx = v % C::HX, hy = (v / C::HX) % C::HY, hz = v / (C::HX * C::HY);
      const int gx = x0 + hx, gy = y0 + hy, gz = z0 + hz;
      const bool in = gx < OW && gy < OH && gz < OD;
      const __nv_bfloat16* src = in ? g + (((long)gz * OH + gy) * OW + gx) * CO + c * 8 : g;
      cp_async16(halo + v * CO * 2 + pc * 16, src, in ? 16 : 0);
    }
    if constexpr (C::RESIDENT) {
      if (!w_loaded) copy_async(wbuf, wpk, C::STAGE_BYTES);
      w_loaded = true;
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
#pragma unroll
      for (int st = 0; st < RING - 1; ++st) {
        copy_async(wbuf + st * C::STAGE_BYTES, wpk + (long)st * C::STAGE_BYTES, C::STAGE_BYTES);
        cp_async_commit();
      }
    }

    int tap = 0;  // global tap index in class order (the weight stage)
#pragma unroll 1
    for (int p = 0; p < 8; ++p) {
      const int pz = p >> 2, py = (p >> 1) & 1, px = p & 1;
      float acc[CI / 8][4];
#pragma unroll
      for (int nt = 0; nt < CI / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll 1
      for (int a = 0; a < 1 + pz; ++a)
#pragma unroll 1
        for (int b_ = 0; b_ < 1 + py; ++b_)
#pragma unroll 1
          for (int e = 0; e < 1 + px; ++e, ++tap) {
            const unsigned char* ws;
            if constexpr (C::RESIDENT) {
              ws = wbuf + tap * C::CK * C::KSTEP_BYTES;
            } else {
              cp_async_wait<RING - 2>();
              __syncthreads();  // tap's weights (and the halo) have landed
              const int nx = tap + RING - 1;
              if (nx < 27)
                copy_async(wbuf + (nx % RING) * C::STAGE_BYTES,
                           wpk + (long)nx * C::STAGE_BYTES, C::STAGE_BYTES);
              cp_async_commit();
              ws = wbuf + (tap % RING) * C::STAGE_BYTES;
            }
            const int v = ((zz + a) * C::HY + (yy + b_)) * C::HX + (lane & 15) + e;
            // the tap's chunks in groups of G: all of a group's fragments
            // are loaded before its MMAs
#pragma unroll
            for (int c0 = 0; c0 < C::CK; c0 += C::G) {
              uint32_t bf[C::G][CI / 8][2], af[C::G][4];
#pragma unroll
              for (int j = 0; j < C::G; ++j) {
                load_b<CI>(bf[j], ws + (c0 + j) * C::KSTEP_BYTES, lane);
                ldsm_x4(af[j], halo_u32 + v * CO * 2 +
                                   swz<C::NC>(v, (c0 + j) * 2 + (lane >> 4)) * 16);
              }
#pragma unroll
              for (int j = 0; j < C::G; ++j)
#pragma unroll
                for (int nt = 0; nt < CI / 8; ++nt)
                  mma_bf16(acc[nt], af[j], bf[j][nt][0], bf[j][nt][1]);
            }
          }
      // this class's dx voxels (2q + parity), interleaved in the dx tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xq = gq + 8 * h;
        const int m = ((2 * zz + pz) * C::DY + (2 * yy + py)) * C::DX + 2 * xq + px;
#pragma unroll
        for (int nt = 0; nt < CI / 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(outb + m * C::SROW + (nt * 8 + 2 * t) * 2) =
              __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < C::DZ * C::DY * C::DX * (CI / 8); i += TC_THREADS) {
      const int m = i / (CI / 8), c = i % (CI / 8);
      const int lx = m % C::DX, ly = (m / C::DX) % C::DY, lz = m / (C::DX * C::DY);
      const int ix = 2 * x0 + lx, iy = 2 * y0 + ly, iz = 2 * z0 + lz;
      if (iz < D && iy < H && ix < W)
        *reinterpret_cast<uint4*>(dx + (((long)iz * H + iy) * W + ix) * CI + c * 8) =
            *reinterpret_cast<const uint4*>(outb + m * C::SROW + c * 16);
    }
    __syncthreads();  // halo and staging are free for the next tile
  }
}

// ---------------------------------------------------------------------------
// K5: weight gradient of the 3^3 stride-1 pad-1 conv, x (D, H, W, CI) and
// g (D, H, W, CO) -> per-block partials of dW (27, CI, CO), f32
// ---------------------------------------------------------------------------
//
// out[t][ci][co] = sum_o x[o + t - 1][ci] g[o][co] is a GEMM per tap t
// with M = CI, N = CO and K = every voxel o: A = x^T shifted by the tap,
// B = g.  A block takes a slice of DW_NB output channels (grid.y) and
// walks tiles of TZ x TY x 16 output voxels (grid.x, persistent, one
// tile after another); K is walked in k-steps of the 16 voxels of one x
// row (a k-row).  A tile stages g's slice (zero past the ragged edge, so
// those voxels add nothing) and x's halo, (TZ+2) x (TY+2) x 18 voxels
// (zero outside the volume), with cp.async, as rows of 16-byte chunks
// XOR-swizzled by voxel as in K1, double-buffered: the next tile's copies
// fly while this tile's MMAs run.  Both operands are stored voxel-major,
// K-major for the mma, so both come through ldmatrix.trans: a tap's A is
// the halo read at a shift of (dz, dy, dx) voxels, one row address per
// lane, whatever the shift.
// Warp w of 9 owns the column (dz, dx) = (w / 3, w % 3) of taps, all
// three dy, every m-tile, and the slice's two n-tiles, with its
// accumulators in registers for the whole tile walk.  Walking the k-rows
// of a z plane in y order, the A fragment of halo row y + 2 serves tap
// dy = 2 at k-row y, dy = 1 at y + 1 and dy = 0 at y + 2: a window of
// fragments per m-tile slides down the plane, one ldmatrix per k-row and
// m-tile for 6 MMAs, beside the k-row's one B load; the next k-row's
// fragments are loaded before this one's MMAs.
// The block writes its accumulators as its slice of the (nblk, 27, CI,
// CO) partial buffer; unet_dw_reduce (conv_bwd.cu) adds the blocks in a
// fixed order, so dW is bitwise the same from run to run.
// dw_entry_tc_kernel, the entry (CI = 1): A is the im2col of the
// one-channel halo, its 27 taps padded to 32 (two m-tiles) per voxel,
// built in shared memory as in entry_tc_kernel; its two jobs are too few
// for the warps, so 8 warps share out the k-rows instead and add their
// accumulators in warp order; the next tile's halo is loaded into
// registers while this tile's MMAs run.
// The tile geometry, the job map and the partial shape are those of
// ops/tc_layout.py (dw_*), which the CPU tests replay against the twin.
// The stride-2 form (K6, dw_s2_tc_kernel) changes the halo's extent and a
// tap's voxel offset; the ks2 form (K9) has no halo and is trans_tc.cu's.
//
// What bounds it on the H100 (bf16 in, f32 out): level 0, 16->16, moves
// 528 MB (0.158 ms) for 114 GFLOP (0.115 ms at the bf16 tensor-core peak),
// so bytes; levels 1 and 2 (32->32, 64->64) are bound by operations.

#define DW_NB 16       // output channels per block (two n-tiles)
#define DW_WARPS 9     // one per (dz, dx) tap column
#define DW_THREADS (DW_WARPS * 32)
#define DWE_WARPS 8    // the entry's warps
#define DWE_THREADS (DWE_WARPS * 32)

template <int CI>
struct DwCfg {
  static constexpr int TZ = CI == 64 ? 1 : 2, TY = 8;
  static constexpr int KROWS = TZ * TY;     // k-rows per tile
  static constexpr int TV = KROWS * TC_TX;  // output voxels per tile
  static constexpr int HZ = TZ + 2, HY = TY + 2, HX = TC_TX + 2;
  static constexpr int HV = HZ * HY * HX;
  static constexpr int NC = CI / 8;  // 16-byte chunks per halo row
  static constexpr int MT = CI / 16;  // m-tiles
  static constexpr int HALO_BYTES = HV * CI * 2;
  static constexpr int G_BYTES = TV * DW_NB * 2;
  static constexpr int STAGE_BYTES = HALO_BYTES + G_BYTES;
  static constexpr int SMEM = 2 * STAGE_BYTES;
};

// cp.async g's (NCG * 8)-channel slice of a tile of TV voxels (TY rows of
// 16 per z plane) into gbuf, zero past the volume
template <int TY, int TV, int NTHR, int NCG = DW_NB / 8>
__device__ __forceinline__ void dw_stage_g(unsigned char* gbuf, const __nv_bfloat16* g, int co0,
                                           int CO, int x0, int y0, int z0, int D, int H, int W) {
  for (int i = threadIdx.x; i < TV * NCG; i += NTHR) {
    const int v = i / NCG, pc = i % NCG, c = swz<NCG>(v, pc);
    const int gx = x0 + v % TC_TX, gy = y0 + (v / TC_TX) % TY, gz = z0 + v / (TC_TX * TY);
    const bool in = gx < W && gy < H && gz < D;
    const __nv_bfloat16* src = in ? g + (((long)gz * H + gy) * W + gx) * CO + co0 + c * 8 : g;
    cp_async16(gbuf + v * NCG * 16 + pc * 16, src, in ? 16 : 0);
  }
}

template <int CI>
__global__ void __launch_bounds__(DW_THREADS)
dw_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g, int D,
             int H, int W, int CO, float* __restrict__ part) {
  using C = DwCfg<CI>;
  constexpr int MT = C::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int co0 = blockIdx.y * DW_NB;
  const int dz = warp / 3, dx = warp % 3;  // this warp's tap column
  const int a_row = dw_a_row(lane), a_chunk = dw_a_chunk(lane);
  const int b_row = dw_b_row(lane), b_chunk = dw_b_chunk(lane);
  const int ntx = (W + TC_TX - 1) / TC_TX, nty = (H + C::TY - 1) / C::TY;
  const int ntz = (D + C::TZ - 1) / C::TZ;
  const long ntiles = (long)ntx * nty * ntz;

  // stage x's halo and g's slice of `tile` into buffer `buf`
  auto stage = [&](long tile, int buf) {
    const int x0 = (int)(tile % ntx) * TC_TX;
    const int y0 = (int)((tile / ntx) % nty) * C::TY;
    const int z0 = (int)(tile / ((long)ntx * nty)) * C::TZ;
    unsigned char* hs = smem + buf * C::STAGE_BYTES;
    for (int i = threadIdx.x; i < C::HV * C::NC; i += DW_THREADS) {
      const int v = i / C::NC, pc = i % C::NC, c = swz<C::NC>(v, pc);
      const int hx = v % C::HX, hy = (v / C::HX) % C::HY, hz = v / (C::HX * C::HY);
      const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
      const bool in = gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 && gz < D;
      const __nv_bfloat16* src = in ? x + (((long)gz * H + gy) * W + gx) * CI + c * 8 : x;
      cp_async16(hs + v * CI * 2 + pc * 16, src, in ? 16 : 0);
    }
    dw_stage_g<C::TY, C::TV, DW_THREADS>(hs + C::HALO_BYTES, g, co0, CO, x0, y0, z0, D, H, W);
  };

  float acc[MT][3][2][4];  // [m-tile][dy][n-tile]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][dy][nt][k] = 0.0f;

  int buf = 0;
  if ((long)blockIdx.x < ntiles) stage(blockIdx.x, 0);
  cp_async_commit();
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed (the next one may fly)
    __syncthreads();
    const uint32_t h_u32 = smem_u32(smem + buf * C::STAGE_BYTES);
    const uint32_t g_u32 = h_u32 + C::HALO_BYTES;
    auto load_a = [&](uint32_t* a, int kz, int hy, int mt) {
      const int v = ((kz + dz) * C::HY + hy) * C::HX + dx + a_row;
      ldsm_x4_trans(a, h_u32 + v * CI * 2 + swz<C::NC>(v, mt * 2 + a_chunk) * 16);
    };
#pragma unroll 1
    for (int kz = 0; kz < C::TZ; ++kz) {
      // A of halo rows y .. y + 3 (slot y % 4): rows y, y + 1, y + 2 feed
      // k-row y, row y + 3 and k-row y + 1's B load while its MMAs run
      uint32_t win[MT][4][4], b[2][4];  // b: b0, b1 of n-tile 0, then 1
      auto load_b = [&](uint32_t* bb, int ky) {
        const int vb = (kz * C::TY + ky) * TC_TX + b_row;
        ldsm_x4_trans(bb, g_u32 + vb * 32 + swz<2>(vb, b_chunk) * 16);
      };
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hy = 0; hy < 3; ++hy) load_a(win[mt][hy], kz, hy, mt);
      load_b(b[0], 0);
#pragma unroll
      for (int ky = 0; ky < C::TY; ++ky) {
        if (ky + 1 < C::TY) {
          load_b(b[(ky + 1) & 1], ky + 1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) load_a(win[mt][(ky + 3) % 4], kz, ky + 3, mt);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const uint32_t* a = win[mt][(ky + dy) % 4];
            mma_bf16(acc[mt][dy][0], a, b[ky & 1][0], b[ky & 1][1]);
            mma_bf16(acc[mt][dy][1], a, b[ky & 1][2], b[ky & 1][3]);
          }
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is staged again
  }

  // the block's partial: acc[mt][dy][nt] holds rows (g, g + 8) of m-tile
  // mt and columns 2t, 2t + 1 of n-tile nt, for tap (dz, dy, dx)
  const int gq = lane >> 2, t = lane & 3;
  float* out = part + (long)blockIdx.x * 27 * CI * CO;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tap = dz * 9 + dy * 3 + dx;
          const int ci = mt * 16 + gq + 8 * h, co = co0 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(out + ((long)tap * CI + ci) * CO + co) =
              make_float2(acc[mt][dy][nt][2 * h], acc[mt][dy][nt][2 * h + 1]);
        }
}

struct DwEntryCfg {
  static constexpr int TZ = 2, TY = 8;
  static constexpr int KROWS = TZ * TY, TV = KROWS * TC_TX;
  static constexpr int HZ = TZ + 2, HY = TY + 2, HX = TC_TX + 2;
  static constexpr int HV = HZ * HY * HX;
  static constexpr int HPT = (HV + DWE_THREADS - 1) / DWE_THREADS;  // halo values per thread
  static constexpr int A_BYTES = TV * 64;  // im2col: 32 bf16 taps per voxel
  static constexpr int G_BYTES = TV * DW_NB * 2;
  static constexpr int SMEM = A_BYTES + 2 * G_BYTES + ((HV * 2 + 15) / 16) * 16;
  static_assert(DWE_WARPS * 32 * DW_NB * 4 <= A_BYTES, "the warps' sums fit in the im2col");
};

__global__ void __launch_bounds__(DWE_THREADS, 3)
dw_entry_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                   int D, int H, int W, int CO, float* __restrict__ part) {
  using C = DwEntryCfg;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* abuf = smem;                      // im2col, then the warps' sums
  unsigned char* gbuf = smem + C::A_BYTES;         // g's slice, two buffers
  unsigned short* hs = reinterpret_cast<unsigned short*>(gbuf + 2 * C::G_BYTES);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = blockIdx.y * DW_NB;
  const int a_row = dw_a_row(lane), a_chunk = dw_a_chunk(lane);
  const int b_row = dw_b_row(lane), b_chunk = dw_b_chunk(lane);
  const int ntx = (W + TC_TX - 1) / TC_TX, nty = (H + C::TY - 1) / C::TY;
  const int ntz = (D + C::TZ - 1) / C::TZ;
  const long ntiles = (long)ntx * nty * ntz;
  const uint32_t a_u32 = smem_u32(abuf);

  unsigned short hv[C::HPT];  // this thread's halo values of the next tile
  auto origin = [&](long tile, int& x0, int& y0, int& z0) {
    x0 = (int)(tile % ntx) * TC_TX;
    y0 = (int)((tile / ntx) % nty) * C::TY;
    z0 = (int)(tile / ((long)ntx * nty)) * C::TZ;
  };
  // the one-channel halo into registers, 2-byte loads, 0 outside the volume
  auto fetch_halo = [&](long tile) {
    int x0, y0, z0;
    origin(tile, x0, y0, z0);
#pragma unroll
    for (int k = 0; k < C::HPT; ++k) {
      const int v = tid + k * DWE_THREADS;
      const int hx = v % C::HX, hy = (v / C::HX) % C::HY, hz = v / (C::HX * C::HY);
      const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
      const bool in = v < C::HV && gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 && gz < D;
      hv[k] = in ? xs[((long)gz * H + gy) * W + gx] : (unsigned short)0;
    }
  };
  auto stage_g = [&](long tile, int buf) {
    int x0, y0, z0;
    origin(tile, x0, y0, z0);
    dw_stage_g<C::TY, C::TV, DWE_THREADS>(gbuf + buf * C::G_BYTES, g, co0, CO, x0, y0, z0, D,
                                          H, W);
  };

  float acc[2][2][4];  // [m-tile][n-tile]: the 32 padded taps x 16 channels
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.0f;

  int buf = 0;
  if ((long)blockIdx.x < ntiles) {
    fetch_halo(blockIdx.x);
    stage_g(blockIdx.x, 0);
  }
  cp_async_commit();
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const long next = tile + gridDim.x;
#pragma unroll
    for (int k = 0; k < C::HPT; ++k)
      if (tid + k * DWE_THREADS < C::HV) hs[tid + k * DWE_THREADS] = hv[k];
    if (next < ntiles) stage_g(next, buf ^ 1);
    cp_async_commit();
    __syncthreads();  // the halo is in place
    // im2col: row m holds the 27 taps of output voxel m and 5 zeros, as
    // four swizzled chunks of 8 taps; thread builds chunk tid % 4
    {
      const int c = tid % 4;
      for (int i = tid; i < C::TV * 4; i += DWE_THREADS) {
        const int m = i / 4, r = m / TC_TX;
        const int row = ((r / C::TY) * C::HY + r % C::TY) * C::HX + m % TC_TX;
        __align__(16) unsigned short v8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int tap = c * 8 + k;
          v8[k] = tap < 27 ? hs[row + ((tap / 9) * C::HY + (tap / 3) % 3) * C::HX + tap % 3]
                           : (unsigned short)0;
        }
        *reinterpret_cast<uint4*>(abuf + m * 64 + swz<4>(m, c) * 16) =
            *reinterpret_cast<const uint4*>(v8);
      }
    }
    if (next < ntiles) fetch_halo(next);  // in flight during the MMAs
    cp_async_wait<1>();
    __syncthreads();  // the im2col and this tile's g are in place
    const uint32_t g_u32 = smem_u32(gbuf + buf * C::G_BYTES);
#pragma unroll
    for (int r = warp; r < C::KROWS; r += DWE_WARPS) {
      uint32_t b[4];
      const int vb = r * TC_TX + b_row;
      ldsm_x4_trans(b, g_u32 + vb * 32 + swz<2>(vb, b_chunk) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        const int m = r * TC_TX + a_row;
        ldsm_x4_trans(a, a_u32 + m * 64 + swz<4>(m, mt * 2 + a_chunk) * 16);
        mma_bf16(acc[mt][0], a, b[0], b[1]);
        mma_bf16(acc[mt][1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with the im2col, the halo and `buf`
  }

  // the warps' sums, added in warp order: red[warp][tap][16 columns]
  const int gq = lane >> 2, t = lane & 3;
  float* red = reinterpret_cast<float*>(abuf);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + gq + 8 * h, n = nt * 8 + 2 * t;
        red[(warp * 32 + m) * DW_NB + n] = acc[mt][nt][2 * h];
        red[(warp * 32 + m) * DW_NB + n + 1] = acc[mt][nt][2 * h + 1];
      }
  __syncthreads();
  float* out = part + (long)blockIdx.x * 27 * CO;
  for (int i = tid; i < 27 * DW_NB; i += DWE_THREADS) {
    float s = 0.0f;
    for (int w = 0; w < DWE_WARPS; ++w) s += red[w * 32 * DW_NB + i];
    out[(i / DW_NB) * CO + co0 + i % DW_NB] = s;
  }
}

// ---------------------------------------------------------------------------
// K6: weight gradient of the 3^3 stride-2 pad-1 conv, x (D, H, W, CI) and
// g (D/2, H/2, W/2, CO) -> per-block partials of dW (27, CI, CO), f32
// ---------------------------------------------------------------------------
//
// K5's structure with K3's halo: out[t][ci][co] = sum_o x[2o + t - 1][ci]
// g[o][co], per tap a GEMM with M = CI, N = the block's NB channels of CO
// (grid.y), K = the voxels o of g in k-rows of 16 x.  A tile of g is TZ x
// TY x 16 voxels; x's halo for it, (2TZ+1) x (2TY+1) x 33 voxels, is
// staged split by x parity as in K3 (s2_slot), so a tap's 16 A rows are
// 16 consecutive slots, one row address per lane for ldmatrix.trans, and
// the voxel swizzle keeps every phase on 8 bank groups.  Both tiles are
// double-buffered cp.async stages; accumulators stay in registers over
// the persistent tile walk; per-block partials go through unet_dw_reduce.
// NB = 32 (4 n-tiles) at CI = 16 and 32, so x's halo is staged once per
// 32 output channels; 16 at CI = 64, where the accumulators would not fit.
// Warp w owns the tap column (dz, dx) = (w / 3, w % 3), all dy and
// m-tiles.  Walking the k-rows y of a z plane, halo row 2y + dy feeds tap
// dy: the even row 2y + 2 serves dy = 2 at k-row y and dy = 0 at y + 1,
// the odd rows one tap, so a window of A fragments slides two rows per
// k-row (one row in three shared, against two in K5); at CI < 64 the next
// k-row's two rows and B are loaded before this one's MMAs.
// Its geometry is ops/tc_layout.py's dw_* with stride 2, replayed by the
// CPU tests.
//
// What bounds it on the H100 (bf16 in, f32 out): level 0, 16 -> 32,
// reads x (264 MB) and g (66 MB): 0.099 ms at 3.35 TB/s against 0.029 ms
// of operations (28.5 GFLOP), so bytes.

template <int CI>
struct DwS2Cfg {
  static constexpr int NB = CI == 64 ? 16 : 32;  // output channels per block
  static constexpr int NT = NB / 8;              // n-tiles
  static constexpr int NCG = NB / 8;             // 16-byte chunks per g row
  static constexpr int TZ = 2, TY = CI == 64 ? 2 : 4;
  static constexpr int KROWS = TZ * TY, TV = KROWS * TC_TX;
  static constexpr int HZ = 2 * TZ + 1, HY = 2 * TY + 1, HX = 2 * TC_TX + 1;
  static constexpr int HV = HZ * HY * HX;
  static constexpr int NC = CI / 8, MT = CI / 16;
  static constexpr int HALO_BYTES = HV * CI * 2;
  static constexpr int G_BYTES = TV * NB * 2;
  static constexpr int STAGE_BYTES = HALO_BYTES + G_BYTES;
  static constexpr int SMEM = 2 * STAGE_BYTES;
  static constexpr bool PREFETCH = MT < 4;
  static constexpr int SLOTS = PREFETCH ? 6 : 3;  // A fragments held per m-tile
  // ops/tc_layout.py DW_S2_BLOCKS_PER_SM: what shared memory allows
  static constexpr int BLOCKS_PER_SM = CI == 16 ? 2 : 1;
  static_assert(BLOCKS_PER_SM * (SMEM + 1024) <= 233472, "the stages fit the SM");
};

template <int CI>
__global__ void __launch_bounds__(DW_THREADS, DwS2Cfg<CI>::BLOCKS_PER_SM)
dw_s2_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                int OD, int OH, int OW, int CO, float* __restrict__ part) {
  using C = DwS2Cfg<CI>;
  constexpr int MT = C::MT, NT = C::NT, S = C::SLOTS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int co0 = blockIdx.y * C::NB;
  const int dz = warp / 3, dx = warp % 3;  // this warp's tap column
  const int a_slot = s2_slot(dx) + dw_a_row(lane), a_chunk = dw_a_chunk(lane);
  const int b_row = dw_b_row(lane), b_chunk = dw_b_chunk(lane);
  const int D = 2 * OD, H = 2 * OH, W = 2 * OW;
  const int ntx = (OW + TC_TX - 1) / TC_TX, nty = (OH + C::TY - 1) / C::TY;
  const int ntz = (OD + C::TZ - 1) / C::TZ;
  const long ntiles = (long)ntx * nty * ntz;

  // stage x's halo and g's slice of `tile` into buffer `buf`
  auto stage = [&](long tile, int buf) {
    const int x0 = (int)(tile % ntx) * TC_TX;
    const int y0 = (int)((tile / ntx) % nty) * C::TY;
    const int z0 = (int)(tile / ((long)ntx * nty)) * C::TZ;
    unsigned char* hs = smem + buf * C::STAGE_BYTES;
    for (int i = threadIdx.x; i < C::HV * C::NC; i += DW_THREADS) {
      const int v = i / C::NC, pc = i % C::NC, c = swz<C::NC>(v, pc);
      int gx, gy, gz;
      s2_halo_xyz<C::HY>(v, x0, y0, z0, gx, gy, gz);
      const bool in = gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 && gz < D;
      const __nv_bfloat16* src = in ? x + (((long)gz * H + gy) * W + gx) * CI + c * 8 : x;
      cp_async16(hs + v * CI * 2 + pc * 16, src, in ? 16 : 0);
    }
    dw_stage_g<C::TY, C::TV, DW_THREADS, C::NCG>(hs + C::HALO_BYTES, g, co0, CO, x0, y0, z0, OD,
                                                 OH, OW);
  };

  float acc[MT][3][NT][4];  // [m-tile][dy][n-tile]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][dy][nt][k] = 0.0f;

  int buf = 0;
  if ((long)blockIdx.x < ntiles) stage(blockIdx.x, 0);
  cp_async_commit();
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed (the next one may fly)
    __syncthreads();
    const uint32_t h_u32 = smem_u32(smem + buf * C::STAGE_BYTES);
    const uint32_t g_u32 = h_u32 + C::HALO_BYTES;
#pragma unroll 1
    for (int kz = 0; kz < C::TZ; ++kz) {
      const int hz = 2 * kz + dz;
      uint32_t win[MT][S][4], b[2][NT / 2][4];  // b[1]: with PREFETCH only
      auto load_a = [&](uint32_t* a, int hy, int mt) {
        const int v = (hz * C::HY + hy) * C::HX + a_slot;
        ldsm_x4_trans(a, h_u32 + v * CI * 2 + swz<C::NC>(v, mt * 2 + a_chunk) * 16);
      };
      // b[q]: b0, b1 of n-tile 2q, then of n-tile 2q + 1
      auto load_b = [&](uint32_t (*bb)[4], int ky) {
        const int vb = (kz * C::TY + ky) * TC_TX + b_row;
#pragma unroll
        for (int q = 0; q < NT / 2; ++q)
          ldsm_x4_trans(bb[q], g_u32 + vb * C::NB * 2 + swz<C::NCG>(vb, 2 * q + b_chunk) * 16);
      };
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hy = 0; hy < 3; ++hy) load_a(win[mt][hy % S], hy, mt);
      load_b(b[0], 0);
#pragma unroll
      for (int ky = 0; ky < C::TY; ++ky) {
        // rows 2ky + 3 and 2ky + 4 (k-row ky + 1's new rows) and its B:
        // before this k-row's MMAs with PREFETCH, else after them
        auto next = [&](uint32_t (*bb)[4]) {
          load_b(bb, ky + 1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            load_a(win[mt][(2 * ky + 3) % S], 2 * ky + 3, mt);
            load_a(win[mt][(2 * ky + 4) % S], 2 * ky + 4, mt);
          }
        };
        if constexpr (C::PREFETCH) {
          if (ky + 1 < C::TY) next(b[(ky + 1) % 2]);
        }
        const int bi = C::PREFETCH ? (ky & 1) : 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const uint32_t* a = win[mt][(2 * ky + dy) % S];
#pragma unroll
            for (int q = 0; q < NT / 2; ++q) {
              mma_bf16(acc[mt][dy][2 * q], a, b[bi][q][0], b[bi][q][1]);
              mma_bf16(acc[mt][dy][2 * q + 1], a, b[bi][q][2], b[bi][q][3]);
            }
          }
        if constexpr (!C::PREFETCH) {
          if (ky + 1 < C::TY) next(b[0]);
        }
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is staged again
  }

  // the block's partial: acc[mt][dy][nt] holds rows (g, g + 8) of m-tile
  // mt and columns 2t, 2t + 1 of n-tile nt, for tap (dz, dy, dx)
  const int gq = lane >> 2, t = lane & 3;
  float* out = part + (long)blockIdx.x * 27 * CI * CO;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tap = dz * 9 + dy * 3 + dx;
          const int ci = mt * 16 + gq + 8 * h, co = co0 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(out + ((long)tap * CI + ci) * CO + co) =
              make_float2(acc[mt][dy][nt][2 * h], acc[mt][dy][nt][2 * h + 1]);
        }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Grid (blocks along x) of each forward kernel: the rows of its stats
// partial buffer.  The wrappers ask for it (unet_conv3_tc_rows) to size
// that buffer, and the launches use the same function.
template <int CI, int CO, int NSRC, int TZ>
static unsigned k1_grid(int D, int H, int W) {
  using C = K1Cfg<CI, CO, NSRC, TZ>;
  const long ntiles = (long)((W + TC_TX - 1) / TC_TX) * ((H + C::TY - 1) / C::TY) *
                      ((D + TZ - 1) / TZ);
  return grid_for(conv3_tc_kernel<CI, CO, NSRC, TZ>, C::SMEM, ntiles, C::RESIDENT);
}

template <int CO>
static unsigned entry_grid(int D, int H, int W) {
  using C = EntryCfg<CO>;
  const long ntiles = (long)((W + TC_TX - 1) / TC_TX) * ((H + C::TY - 1) / C::TY) *
                      ((D + C::TZ - 1) / C::TZ);
  return grid_for(entry_tc_kernel<CO>, C::SMEM, ntiles, true);
}

template <int CI, int CO>
static unsigned k3_grid(int D, int H, int W) {
  using C = K3Cfg<CI, CO>;
  const int OD = D / 2, OH = H / 2, OW = W / 2;
  const long ntiles = (long)((OW + TC_TX - 1) / TC_TX) * ((OH + C::TY - 1) / C::TY) *
                      ((OD + C::TZ - 1) / C::TZ);
  return grid_for(s2_tc_kernel<CI, CO>, C::SMEM, ntiles, C::RESIDENT);
}

// The second pass of the stats: stats[i] = sum over the rows, in order, of
// part[row][i] (2 * co values per row).
extern "C" int unet_dw_reduce(const void* part, int nblk, long n, void* out, void* stream);

static int fold_stats(void* part, unsigned rows, int co, void* stats, cudaStream_t s) {
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || part == nullptr) return rc;
  return unet_dw_reduce(part, (int)rows, 2L * co, stats, s);
}

template <int CI, int CO, int NSRC, int TZ>
static int launch_k1(const void* xa, const void* pa_a, const void* pb_a, int act_a,
                     const void* xb, const void* pa_b, const void* pb_b, int act_b,
                     const void* w, const void* bias, void* y, void* part, void* stats, int D,
                     int H, int W, cudaStream_t s) {
  using C = K1Cfg<CI, CO, NSRC, TZ>;
  const unsigned grid = k1_grid<CI, CO, NSRC, TZ>(D, H, W);
  conv3_tc_kernel<CI, CO, NSRC, TZ><<<grid, TC_THREADS, C::SMEM, s>>>(
      (const __nv_bfloat16*)xa, (const float*)pa_a, (const float*)pb_a, act_a,
      (const __nv_bfloat16*)xb, (const float*)pa_b, (const float*)pb_b, act_b,
      (const unsigned char*)w, (const float*)bias, (__nv_bfloat16*)y, (float*)part, D, H, W);
  return fold_stats(part, grid, CO, stats, s);
}

template <int CO>
static int launch_entry(const void* x, const void* w, const void* bias, void* y, void* part,
                        void* stats, int D, int H, int W, cudaStream_t s) {
  using C = EntryCfg<CO>;
  const unsigned grid = entry_grid<CO>(D, H, W);
  entry_tc_kernel<CO><<<grid, TC_THREADS, C::SMEM, s>>>(
      (const __nv_bfloat16*)x, (const unsigned char*)w, (const float*)bias, (__nv_bfloat16*)y,
      (float*)part, D, H, W);
  return fold_stats(part, grid, CO, stats, s);
}

template <int CI, int CO>
static int launch_k3(const void* x, const void* pa, const void* pb, int act, const void* w,
                     const void* bias, void* y, void* part, void* stats, int D, int H, int W,
                     cudaStream_t s) {
  using C = K3Cfg<CI, CO>;
  const unsigned grid = k3_grid<CI, CO>(D, H, W);
  s2_tc_kernel<CI, CO><<<dim3(grid, CO / C::NB), TC_THREADS, C::SMEM, s>>>(
      (const __nv_bfloat16*)x, (const float*)pa, (const float*)pb, act, (const unsigned char*)w,
      (const float*)bias, (__nv_bfloat16*)y, (float*)part, D, H, W);
  return fold_stats(part, grid, CO, stats, s);
}

template <int CI, int CO>
static void launch_s2dx(const void* g, const void* w, void* dx, int OD, int OH, int OW,
                        cudaStream_t s) {
  using C = S2Cfg<CI, CO>;
  const long ntiles = (long)((OW + TC_TX - 1) / TC_TX) * ((OH + C::TY - 1) / C::TY) *
                      ((OD + C::TZ - 1) / C::TZ);
  auto kernel = s2dx_tc_kernel<CI, CO>;
  const unsigned grid = grid_for(kernel, C::SMEM, ntiles, C::RESIDENT);
  kernel<<<grid, TC_THREADS, C::SMEM, s>>>((const __nv_bfloat16*)g, (const unsigned char*)w,
                                           (__nv_bfloat16*)dx, OD, OH, OW);
}

template <typename K>
static void launch_dw_tc(K kernel, int threads, int smem, const void* x, const void* g, int D,
                         int H, int W, int co, void* part, int nblk, cudaStream_t s) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<dim3((unsigned)nblk, (unsigned)(co / DW_NB)), threads, smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, D, H, W, co, (float*)part);
}

template <int CI>
static void launch_dw_s2(const void* x, const void* g, int OD, int OH, int OW, int co,
                         void* part, int nblk, cudaStream_t s) {
  using C = DwS2Cfg<CI>;
  auto kernel = dw_s2_tc_kernel<CI>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  kernel<<<dim3((unsigned)nblk, (unsigned)(co / C::NB)), DW_THREADS, C::SMEM, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, OD, OH, OW, co, (float*)part);
}

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 on success),
// or cudaErrorInvalidValue for a channel count it has no instance for.
// The wrappers (ops/conv.py) have checked dtype (bf16), shapes,
// contiguity, 16-byte alignment and the channel counts, and packed w
// (ops/tc_layout.py).

// The forward entries take part: (rows, 2, co) f32 scratch, rows from
// unet_conv3_tc_rows, and stats: (2, co) f32, both null without stats.
// The kernel writes one row of partial sums per block, and a second
// launch (unet_dw_reduce) adds the rows in order into stats, so the stats
// are bitwise the same from run to run.

// K1: ci channels per source (nsrc sources), co = ci
int unet_conv3_tc(const void* xa, const void* pa_a, const void* pb_a, int act_a, const void* xb,
                  const void* pa_b, const void* pb_b, int act_b, int ci, const void* w,
                  const void* bias, void* y, void* part, void* stats, int D, int H, int W, int co,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool dual = xb != nullptr;
#define K1_CASE(C_, TZ_)                                                                     \
  if (ci == C_ && co == C_) {                                                                \
    if (dual)                                                                                \
      return launch_k1<C_, C_, 2, TZ_>(xa, pa_a, pb_a, act_a, xb, pa_b, pb_b, act_b, w, bias, \
                                       y, part, stats, D, H, W, s);                          \
    return launch_k1<C_, C_, 1, TZ_>(xa, pa_a, pb_a, act_a, xb, pa_b, pb_b, act_b, w, bias,   \
                                     y, part, stats, D, H, W, s);                            \
  }
  K1_CASE(16, 2)
  K1_CASE(32, 2)
  K1_CASE(64, 1)
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

int unet_conv3_entry_tc(const void* x, const void* w, const void* bias, void* y, void* part,
                        void* stats, int D, int H, int W, int co, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (co == 16) return launch_entry<16>(x, w, bias, y, part, stats, D, H, W, s);
  if (co == 32) return launch_entry<32>(x, w, bias, y, part, stats, D, H, W, s);
  if (co == 64) return launch_entry<64>(x, w, bias, y, part, stats, D, H, W, s);
  return (int)cudaErrorInvalidValue;
}

// K3: x (D, H, W, ci) -> y (D/2, H/2, W/2, co), co = 2 ci
int unet_conv3_s2_tc(const void* x, const void* pa, const void* pb, int act, int ci,
                     const void* w, const void* bias, void* y, void* part, void* stats, int D,
                     int H, int W, int co, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 16 && co == 32)
    return launch_k3<16, 32>(x, pa, pb, act, w, bias, y, part, stats, D, H, W, s);
  if (ci == 32 && co == 64)
    return launch_k3<32, 64>(x, pa, pb, act, w, bias, y, part, stats, D, H, W, s);
  if (ci == 64 && co == 128)
    return launch_k3<64, 128>(x, pa, pb, act, w, bias, y, part, stats, D, H, W, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of the stats partial buffer of a forward launch on an input of
// (D, H, W): kind 0 K1 (one source), 1 K1 dual, 2 the entry (ci = 1),
// 3 K3; -1 for a channel count without an instance.
int unet_conv3_tc_rows(int kind, int ci, int co, int D, int H, int W) {
  if (kind == 0 || kind == 1) {
#define K1_ROWS(C_, TZ_)                                                            \
  if (ci == C_ && co == C_)                                                         \
    return (int)(kind ? k1_grid<C_, C_, 2, TZ_>(D, H, W) : k1_grid<C_, C_, 1, TZ_>(D, H, W));
    K1_ROWS(16, 2)
    K1_ROWS(32, 2)
    K1_ROWS(64, 1)
#undef K1_ROWS
  } else if (kind == 2) {
    if (co == 16) return (int)entry_grid<16>(D, H, W);
    if (co == 32) return (int)entry_grid<32>(D, H, W);
    if (co == 64) return (int)entry_grid<64>(D, H, W);
  } else if (kind == 3) {
    if (ci == 16 && co == 32) return (int)k3_grid<16, 32>(D, H, W);
    if (ci == 32 && co == 64) return (int)k3_grid<32, 64>(D, H, W);
    if (ci == 64 && co == 128) return (int)k3_grid<64, 128>(D, H, W);
  }
  return -1;
}

// K5: x (D, H, W, ci), g (D, H, W, co) -> dW (27, ci, co) f32 in out, through
// part: (nblk, 27, ci, co) f32 scratch; nblk blocks per co slice of 16
// (ops/tc_layout.py dw_blocks)
int unet_conv_dw_tc(const void* x, const void* g, int D, int H, int W, int ci, int co,
                    void* part, int nblk, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (co % DW_NB || co < DW_NB || co > 64) return (int)cudaErrorInvalidValue;
  if (ci == 1)
    launch_dw_tc(dw_entry_tc_kernel, DWE_THREADS, DwEntryCfg::SMEM, x, g, D, H, W, co, part,
                 nblk, s);
  else if (ci == 16)
    launch_dw_tc(dw_tc_kernel<16>, DW_THREADS, DwCfg<16>::SMEM, x, g, D, H, W, co, part, nblk, s);
  else if (ci == 32)
    launch_dw_tc(dw_tc_kernel<32>, DW_THREADS, DwCfg<32>::SMEM, x, g, D, H, W, co, part, nblk, s);
  else if (ci == 64)
    launch_dw_tc(dw_tc_kernel<64>, DW_THREADS, DwCfg<64>::SMEM, x, g, D, H, W, co, part, nblk, s);
  else
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return unet_dw_reduce(part, nblk, 27L * ci * co, out, stream);
}

// K6: x (2OD, 2OH, 2OW, ci), g (OD, OH, OW, co) -> dW (27, ci, co) f32 in
// out, through part: (nblk, 27, ci, co) f32 scratch; nblk blocks per co
// slice (ops/tc_layout.py dw_blocks with stride 2)
int unet_conv_dw_s2_tc(const void* x, const void* g, int OD, int OH, int OW, int ci, int co,
                       void* part, int nblk, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 16 && co == 32)
    launch_dw_s2<16>(x, g, OD, OH, OW, co, part, nblk, s);
  else if (ci == 32 && co == 64)
    launch_dw_s2<32>(x, g, OD, OH, OW, co, part, nblk, s);
  else if (ci == 64 && co == 128)
    launch_dw_s2<64>(x, g, OD, OH, OW, co, part, nblk, s);
  else
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return unet_dw_reduce(part, nblk, 27L * ci * co, out, stream);
}

// K7: g (OD, OH, OW, co) -> dx (2OD, 2OH, 2OW, ci)
int unet_conv3_s2_dx_tc(const void* g, int co, const void* w, void* dx, int OD, int OH, int OW,
                        int ci, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 16 && co == 32)
    launch_s2dx<16, 32>(g, w, dx, OD, OH, OW, s);
  else if (ci == 32 && co == 64)
    launch_s2dx<32, 64>(g, w, dx, OD, OH, OW, s);
  else if (ci == 64 && co == 128)
    launch_s2dx<64, 128>(g, w, dx, OD, OH, OW, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
