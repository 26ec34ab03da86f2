// Shared helpers of the port's CUDA kernels: dtype conversion, the
// prologue activation, and 16-value vector loads/stores of one voxel's
// channel run in the channels-last (D, H, W, C) layout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (ops/_cuda.py)
#define DT_F32 0
#define DT_BF16 1

// prologue activation codes
#define ACT_NONE 0
#define ACT_RELU 1
#define ACT_LEAKY 2  // leaky ReLU, slope 0.01

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// max(v, 0.01 v) is the JAX package's leaky ReLU form (jnp.maximum)
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.0f);
  if (act == ACT_LEAKY) return fmaxf(v, 0.01f * v);
  return v;
}

// Load 16 consecutive values (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = __ldg(q + i);
    out[4 * i] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 v = __ldg(q + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      out[8 * i + 2 * k] = f.x;
      out[8 * i + 2 * k + 1] = f.y;
    }
  }
}

// Store 16 f32 values as T (16-byte aligned destination).
__device__ __forceinline__ void store16(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 packed[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(packed);
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = packed[0];
  q[1] = packed[1];
}
