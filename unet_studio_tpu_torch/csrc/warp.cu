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
// H100's 50 MB L2 (the flagship's packed source is 33 MB), so no table is
// built.  What the window changed is kept, behind the `window` flag:
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
// - MODE_PACKED: the source holds label * 65536 + the image quantized to
//   16 bits of its peak (resample._pack_image_label); the output is the
//   trilinear image times peak / 65535 and the label by weighted majority
//   vote, as _combine_packed_corners computes them.
// - MODE_LINEAR: one continuous channel, trilinear: over the 8 corners in
//   order with window = 0 (sample_linear), per axis x, y, z with window = 1
//   (SupercellLinearSampler.sample's hat contractions).
//
// Positions outside the source give 0.  The kernel keeps the reference's
// order of f32 operations (weights wz * wy * wx, sums over the corners
// c = dz*4 + dy*2 + dx in order, the vote's strict > so the earlier corner
// wins a tie) and is built with -fmad=false, so it equals its plain twin.
//
// What bounds it on the H100: a handful of operations per tap, so the
// bytes: 12 bytes of coordinates per output voxel, the source read once
// (its 8 taps per voxel come from L2) and 4 or 8 bytes written.  The
// design: one thread per 2x2x2 output block (the window's anchor is a
// block's), whose 8 voxels' coordinates it reads, then 8 taps per voxel.

#include <climits>

#include "common.cuh"

#define WARP_THREADS 128
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

__global__ void __launch_bounds__(WARP_THREADS)
warp_kernel(const float* __restrict__ src, int sd, int sh, int sw,
            const float* __restrict__ coords, int od, int oh, int ow,
            const float* __restrict__ peak, float* __restrict__ out_img,
            float* __restrict__ out_lab, int mode, int window) {
  const int bd = (od + 1) / 2, bh = (oh + 1) / 2, bw = (ow + 1) / 2;
  const long b = (long)blockIdx.x * WARP_THREADS + threadIdx.x;
  if (b >= (long)bd * bh * bw) return;
  const int bx = (int)(b % bw);
  const int by = (int)((b / bw) % bh);
  const int bz = (int)(b / ((long)bw * bh));
  const int size[3] = {sd, sh, sw};

  // the block's voxels: position (z, y, x order) and floor
  float pos[8][3];
  int fl[8][3];
  bool inside[8];
  int mn[3] = {INT_MAX, INT_MAX, INT_MAX}, mx[3] = {INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int z = 2 * bz + (v >> 2), y = 2 * by + ((v >> 1) & 1), x = 2 * bx + (v & 1);
    inside[v] = z < od && y < oh && x < ow;
    if (!inside[v]) continue;
    const float* c = coords + (((long)z * oh + y) * ow + x) * 3;
    pos[v][0] = c[2];
    pos[v][1] = c[1];
    pos[v][2] = c[0];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fl[v][a] = (int)floorf(pos[v][a]);
      mn[a] = min(mn[a], fl[v][a]);
      mx[a] = max(mx[a], fl[v][a]);
    }
  }
  int anchor2[3] = {0, 0, 0};  // 2 * anchor per axis
  if (window) {
#pragma unroll
    for (int a = 0; a < 3; ++a) anchor2[a] = 2 * clampi(floordiv4(mn[a] + mx[a] - 2), 0, size[a] / 2 - 1);
  }
  const float scale = mode == MODE_PACKED ? *peak / 65535.0f : 0.0f;

#pragma unroll 1
  for (int v = 0; v < 8; ++v) {
    if (!inside[v]) continue;
    bool valid = true;
    int t0[3], t1[3];
    float f[3], g[3];  // fraction and 1 - fraction per axis
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float p = pos[v][a];
      valid = valid && p >= 0.0f && p <= (float)(size[a] - 1);
      int lo;
      if (window)
        lo = anchor2[a] + clampi(fl[v][a] - anchor2[a], 0, 4);
      else
        lo = clampi(fl[v][a], 0, size[a] - 1);
      t0[a] = min(lo, size[a] - 1);
      t1[a] = min(lo + 1, size[a] - 1);
      f[a] = p - (float)fl[v][a];
      g[a] = 1.0f - f[a];
    }
    float val[8], w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int dz = c >> 2, dy = (c >> 1) & 1, dx = c & 1;
      const long idx = ((long)(dz ? t1[0] : t0[0]) * sh + (dy ? t1[1] : t0[1])) * sw +
                       (dx ? t1[2] : t0[2]);
      val[c] = __ldg(src + idx);
      w[c] = ((dz ? f[0] : g[0]) * (dy ? f[1] : g[1])) * (dx ? f[2] : g[2]);
    }
    const int oz = 2 * bz + (v >> 2), oy = 2 * by + ((v >> 1) & 1), ox = 2 * bx + (v & 1);
    const long o = ((long)oz * oh + oy) * ow + ox;
    const float vf = valid ? 1.0f : 0.0f;
    if (mode == MODE_LINEAR) {
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
      float lab[8], img = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        lab[c] = floorf(val[c] * (1.0f / 65536.0f));
        const float part = w[c] * (val[c] - lab[c] * 65536.0f);
        img = c == 0 ? part : img + part;
      }
      float best_label = lab[0], best_score = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float score = lab[0] == lab[c] ? w[0] : 0.0f;
#pragma unroll
        for (int j = 1; j < 8; ++j) score = score + (lab[j] == lab[c] ? w[j] : 0.0f);
        if (c == 0 || score > best_score) {
          best_score = score;
          best_label = lab[c];
        }
      }
      out_img[o] = (img * scale) * vf;
      out_lab[o] = best_label * vf;
    }
  }
}

extern "C" {

// src: (sd, sh, sw) f32; coords: (od, oh, ow, 3) f32 (x, y, z); out_img
// (and out_lab in MODE_PACKED): (od, oh, ow) f32; peak: one f32 on the
// device (MODE_PACKED).  With window, every size is even and the source's
// at least 6.  Returns cudaGetLastError().
int unet_warp(const void* src, int sd, int sh, int sw, const void* coords, int od, int oh,
              int ow, const void* peak, void* out_img, void* out_lab, int mode, int window,
              void* stream) {
  const long blocks = (long)((od + 1) / 2) * ((oh + 1) / 2) * ((ow + 1) / 2);
  const unsigned grid = (unsigned)((blocks + WARP_THREADS - 1) / WARP_THREADS);
  warp_kernel<<<grid, WARP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)src, sd, sh, sw, (const float*)coords, od, oh, ow, (const float*)peak,
      (float*)out_img, (float*)out_lab, mode, window);
  return (int)cudaGetLastError();
}

}  // extern "C"
