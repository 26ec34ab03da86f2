// K10, K11, K12: the augmentation's warp, one direct-gather kernel.
//
// Replaces, in unet_studio_tpu/ops/pallas_warp.py, the three stages of the
// native-layout warp tail extract_combine_native (_geom_kernel :328,
// _combine_blk_kernel :372, _unblockify_kernel :394; K10), the window-table
// build_table_kernel (_table_planes_kernel :200, _table_swap_kernel
// :243; K11) and the blockified tail extract_combine_packed (_kernel :136;
// K12).  On the TPU a gather costs one transaction per fetched row whatever
// its width, so the JAX package builds a (blocks, 216) table holding the
// 6x6x6 edge-clamped source window of every 2x2x2 output block, fetches one
// row per block and extracts each voxel's 8 corners from it with one-hot
// contractions.  The table and the extraction exist only for that.  Here
// every thread reads its taps straight from the source, which stays in the
// H100's 50 MB L2, so no table is built.  What the window changed is kept,
// behind the `window` flag:
//
// - window = 1, the supercell semantics (resample.py:376-462): per 2x2x2
//   output block and axis, the anchor a = clip((min floor + max floor - 2)
//   // 4, 0, A - 1) with A = source size / 2; each voxel's offset in its
//   window is o = clip(floor - 2a, 0, 4), and its taps are read at
//   min(2a + o + t, size - 1) for t in {0, 1}.  Taps the window does not
//   cover are clamped to its edge, as on the TPU.
// - window = 0, the corner-cell sampler (sample_warp_image_label,
//   sample_linear, sample_majority): taps at min(clip(floor, 0, size - 1)
//   + t, size - 1).
//
// Two modes:
// - MODE_PACKED: the source is warp_pack_kernel's uint32 per voxel, L << 16
//   | I: the image quantized as resample._pack_image_label does it, I =
//   rint(clamp(image / peak, 0, 1) * 65535) with peak = max(K2 max, 1e-12),
//   and the uint8 label L.  The twin's f32 packing L * 65536 + I is an
//   integer below 2^24, exact in f32, so its unpacking (floor(v / 65536),
//   v - L * 65536) gives back exactly L and I (a zero as +0), which are the
//   word's two fields here.  The kernel blends I trilinearly (times peak /
//   65535) and votes L by weighted majority, as _combine_packed_corners
//   does.  (A NaN image voxel packs as I = 0, where the twin's is NaN.)
// - MODE_LINEAR: one continuous f32 channel, trilinear: over the 8 corners
//   in order with window = 0 (sample_linear), per axis x, y, z with window
//   = 1 (SupercellLinearSampler.sample's hat contractions).
//
// Positions outside the source give 0.  The kernel keeps the reference's
// order of f32 operations (weights wz * wy * wx, sums over the corners
// c = dz*4 + dy*2 + dx in order, the vote's strict > so the earlier corner
// wins a tie) and is built with -fmad=false, so it equals its plain twin.
//
// What bounds it on the H100: a handful of operations per tap, so the
// bytes: 12 bytes of coordinates per output voxel, the source read once
// (the image, 4 bytes, and in MODE_PACKED the uint8 label, 1 byte) and 4
// or 8 bytes written; the 8 taps per voxel come from L2 (the packed words
// of the flagship's 192x224x192 are 33 MB, within the 50 MB L2).
//
// warp_pack_kernel quantizes each voxel once, in one pass of 16-byte loads
// and stores (image, label -> packed word), where quantizing each of a
// voxel's 8 taps in the warp (8 divisions and 8 byte gathers more per
// output voxel) kept the warp at 0.241 ms of device time, against 0.125 +
// 0.024 for the gathers and the pass, at the flagship grid on an H100
// (chip_smoke.py, PERF.md §6).
//
// The design: one thread per output voxel.  A warp covers 2 z x 2 y x 8 x
// voxels (lane l: z + l / 16, y + (l / 8) % 2, x + l % 8), so each 2x2x2
// output block's 8 voxels are the 8 lanes that differ in lane bits 0, 3
// and 4, and the window's anchor (the min and max floor over the block's
// voxels inside the output) comes from __shfl_xor over those bits.  A
// block of 4 warps covers 2 z x 8 y x 8 x (warp w: y + 2w).  Each 8-lane
// row reads its coordinates as one run of 96 bytes and stores its 8
// outputs as one 32-byte sector.  The vote scores only the first corner
// of each distinct label (an equal label's score is the same sum, which
// a strict > never prefers), and none when all 8 labels are equal.
// ops/warp.py holds the lane map (warp_block_voxels), the shuffle tree
// (shuffle_block_minmax) and the packing (pack_words), which
// tests/test_torch_warp.py replays against the twin's anchors and
// packing.

#include <climits>

#include "common.cuh"

#define WARP_THREADS 128  // 4 warps: 2 z x 8 y x 8 x output voxels
#define MODE_PACKED 0
#define MODE_LINEAR 1

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(v / 4) for any sign (C++'s / truncates toward zero)
__device__ __forceinline__ int floordiv4(int v) {
  const int q = v / 4;
  return (v % 4 != 0 && v < 0) ? q - 1 : q;
}

__device__ __forceinline__ float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

// one voxel's packed word: label << 16 | rint(clamp(v / peak, 0, 1) * 65535)
__device__ __forceinline__ unsigned pack_word(float v, unsigned char label, float pk) {
  return ((unsigned)label << 16) |
         (unsigned)rintf(__fmul_rn(clamp01(__fdiv_rn(v, pk)), 65535.0f));
}

// the packing of MODE_PACKED's source, 4 voxels a thread (img 16-byte and
// lab 4-byte aligned, as the wrapper ensures), then the tail
__global__ void __launch_bounds__(256)
warp_pack_kernel(const float* __restrict__ img, const unsigned char* __restrict__ lab,
            const float* __restrict__ peak, unsigned* __restrict__ out, long n) {
  const float pk = fmaxf(__ldg(peak), 1e-12f);
  const long stride = (long)gridDim.x * blockDim.x;
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long i = i0; i < n / 4; i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(img) + i);
    const uchar4 l = __ldg(reinterpret_cast<const uchar4*>(lab) + i);
    reinterpret_cast<uint4*>(out)[i] = make_uint4(pack_word(v.x, l.x, pk), pack_word(v.y, l.y, pk),
                                                  pack_word(v.z, l.z, pk), pack_word(v.w, l.w, pk));
  }
  for (long i = n / 4 * 4 + i0; i < n; i += stride) out[i] = pack_word(img[i], lab[i], pk);
}

template <int MODE>
__global__ void __launch_bounds__(WARP_THREADS)
warp_kernel(const void* __restrict__ src, int sd, int sh, int sw,
            const float* __restrict__ coords, int od, int oh, int ow,
            const float* __restrict__ peak, float* __restrict__ out_img,
            float* __restrict__ out_lab, int window) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbx = (ow + 7) / 8, nby = (oh + 7) / 8;
  const int bx = (int)(blockIdx.x % nbx), by = (int)((blockIdx.x / nbx) % nby);
  const int bz = (int)(blockIdx.x / ((unsigned)nbx * nby));
  const int z = 2 * bz + (lane >> 4), y = 8 * by + 2 * warp + ((lane >> 3) & 1);
  const int x = 8 * bx + (lane & 7);
  const bool inside = z < od && y < oh && x < ow;
  const int size[3] = {sd, sh, sw};
  const long o = ((long)z * oh + y) * ow + x;

  // this voxel's position (z, y, x order) and floor
  float pos[3] = {0.0f, 0.0f, 0.0f};
  int fl[3] = {0, 0, 0};
  if (inside) {
    const float* c = coords + o * 3;
    pos[0] = __ldg(c + 2);
    pos[1] = __ldg(c + 1);
    pos[2] = __ldg(c);
#pragma unroll
    for (int a = 0; a < 3; ++a) fl[a] = (int)floorf(pos[a]);
  }
  int anchor2[3] = {0, 0, 0};  // 2 * anchor per axis
  if (window) {                // the same for every thread: all 32 lanes shuffle
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int mn = inside ? fl[a] : INT_MAX, mx = inside ? fl[a] : INT_MIN;
#pragma unroll
      for (int bit = 0; bit < 3; ++bit) {
        const int m = bit == 0 ? 1 : (bit == 1 ? 8 : 16);  // the block's x, y, z lane bits
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, m));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, m));
      }
      anchor2[a] = 2 * clampi(floordiv4(mn + mx - 2), 0, size[a] / 2 - 1);
    }
  }
  if (!inside) return;

  bool valid = true;
  int t0[3], t1[3];
  float f[3], g[3];  // fraction and 1 - fraction per axis
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = pos[a];
    valid = valid && p >= 0.0f && p <= (float)(size[a] - 1);
    int lo;
    if (window)
      lo = anchor2[a] + clampi(fl[a] - anchor2[a], 0, 4);
    else
      lo = clampi(fl[a], 0, size[a] - 1);
    t0[a] = min(lo, size[a] - 1);
    t1[a] = min(lo + 1, size[a] - 1);
    f[a] = p - (float)fl[a];
    g[a] = 1.0f - f[a];
  }
  float pk = 0.0f;
  if (MODE == MODE_PACKED) pk = fmaxf(__ldg(peak), 1e-12f);
  float val[8], labv[8], w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dz = c >> 2, dy = (c >> 1) & 1, dx = c & 1;
    const long idx = ((long)(dz ? t1[0] : t0[0]) * sh + (dy ? t1[1] : t0[1])) * sw +
                     (dx ? t1[2] : t0[2]);
    if (MODE == MODE_PACKED) {  // the tap's image part I and label L
      const unsigned word = __ldg(static_cast<const unsigned*>(src) + idx);
      val[c] = (float)(word & 0xffffu);
      labv[c] = (float)(word >> 16);
    } else {
      val[c] = __ldg(static_cast<const float*>(src) + idx);
    }
    w[c] = ((dz ? f[0] : g[0]) * (dy ? f[1] : g[1])) * (dx ? f[2] : g[2]);
  }
  const float vf = valid ? 1.0f : 0.0f;
  if (MODE == MODE_LINEAR) {
    float out;
    if (window) {  // per axis: x, then y, then z
      float r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = val[2 * i] * g[2] + val[2 * i + 1] * f[2];
      const float s0 = r[0] * g[1] + r[1] * f[1];
      const float s1 = r[2] * g[1] + r[3] * f[1];
      out = s0 * g[0] + s1 * f[0];
    } else {
      out = w[0] * val[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) out = out + w[c] * val[c];
    }
    out_img[o] = out * vf;
  } else {
    float img = w[0] * val[0];
#pragma unroll
    for (int c = 1; c < 8; ++c) img = img + w[c] * val[c];
    float best_label = labv[0];
    bool same = true;
#pragma unroll
    for (int c = 1; c < 8; ++c) same = same && labv[c] == labv[0];
    if (!same) {
      float best_score = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        bool seen = false;  // an earlier corner has this label: the same score
#pragma unroll
        for (int j = 0; j < c; ++j) seen = seen || labv[j] == labv[c];
        if (seen) continue;
        float score = labv[0] == labv[c] ? w[0] : 0.0f;
#pragma unroll
        for (int j = 1; j < 8; ++j) score = score + (labv[j] == labv[c] ? w[j] : 0.0f);
        if (c == 0 || score > best_score) {
          best_score = score;
          best_label = labv[c];
        }
      }
    }
    out_img[o] = (img * (pk / 65535.0f)) * vf;
    out_lab[o] = best_label * vf;
  }
}

extern "C" {

// src: (sd, sh, sw) f32 (MODE_LINEAR) or the image (MODE_PACKED), lab:
// (sd, sh, sw) uint8 (MODE_PACKED), packed: sd * sh * sw uint32 scratch
// (MODE_PACKED); coords: (od, oh, ow, 3) f32 (x, y, z); out_img (and out_lab
// in MODE_PACKED): (od, oh, ow) f32; peak: one f32 on the device, the
// image's K2 max (MODE_PACKED).  With window, every size is even and the
// source's at least 6.  Returns cudaGetLastError().
int unet_warp(const void* src, const void* lab, void* packed, int sd, int sh, int sw,
              const void* coords, int od, int oh, int ow, const void* peak, void* out_img,
              void* out_lab, int mode, int window, void* stream) {
  const long blocks = (long)((od + 1) / 2) * ((oh + 7) / 8) * ((ow + 7) / 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_PACKED) {
    const long n = (long)sd * sh * sw;
    const long grid = (n / 4 + 255) / 256;
    warp_pack_kernel<<<(unsigned)(grid > 0 ? grid : 1), 256, 0, s>>>(
        (const float*)src, (const unsigned char*)lab, (const float*)peak, (unsigned*)packed, n);
    warp_kernel<MODE_PACKED><<<(unsigned)blocks, WARP_THREADS, 0, s>>>(
        packed, sd, sh, sw, (const float*)coords, od, oh, ow, (const float*)peak,
        (float*)out_img, (float*)out_lab, window);
  } else {
    warp_kernel<MODE_LINEAR><<<(unsigned)blocks, WARP_THREADS, 0, s>>>(
        src, sd, sh, sw, (const float*)coords, od, oh, ow, nullptr, (float*)out_img, nullptr,
        window);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
