// Building blocks of the bf16 tensor-core kernels (conv_tc.cu,
// trans_tc.cu): cp.async copies into shared memory, ldmatrix fragment
// loads (plain and transposed), mma.sync.m16n8k16 in bf16 with f32
// accumulators, the 16-byte chunk swizzle, B fragments pre-packed by
// ops/tc_layout.py pack_b, and the host-side grid sizing.
#pragma once

#include "common.cuh"

#define TC_THREADS 128  // 4 warps
#define TC_TX 16        // output x per MMA row block
#define TC_WARPS (TC_THREADS / 32)

// ---------------------------------------------------------------------------
// PTX building blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment of one 16 x 16 tile: lane l gives the shared address of row
// l % 16, 8-column half l / 16
__device__ __forceinline__ void ldsm_x4(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Physical 16-byte chunk of logical chunk c of voxel v in a row-per-voxel
// tile with NC chunks per voxel: 8 consecutive voxels reading the same
// logical chunk land in 8 distinct 16-byte bank groups of a 128-byte line.
template <int NC>
__device__ __forceinline__ int swz(int v, int c) {
  if constexpr (NC >= 8)
    return c ^ (v & 7);
  else
    return c ^ ((v / (8 / NC)) & (NC - 1));
}

// The prologue on one staged 16-byte chunk of 8 bf16 channels, in place:
// act(a x + b) in f32, multiply and add rounded apart (the twin's order),
// rounded to bf16 (ops/conv.py apply_prologue); fa, fb: the chunk's a, b
__device__ __forceinline__ void prologue_chunk(unsigned char* q, const float* fa, const float* fb,
                                               int act) {
  uint4* p = reinterpret_cast<uint4*>(q);
  uint4 u = *p;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    const float r0 = apply_act(__fadd_rn(__fmul_rn(f.x, fa[2 * k]), fb[2 * k]), act);
    const float r1 = apply_act(__fadd_rn(__fmul_rn(f.y, fa[2 * k + 1]), fb[2 * k + 1]), act);
    h2[k] = __floats2bfloat162_rn(r0, r1);
  }
  *p = u;
}

// B fragments of one k-step for all CO/8 n-tiles: lane's 16 bytes per
// pair of n-tiles, packed by ops/tc_layout.py pack_b
template <int CO>
__device__ __forceinline__ void load_b(uint32_t (*b)[2], const unsigned char* kstep, int lane) {
#pragma unroll
  for (int p = 0; p < CO / 16; ++p) {
    const uint4 v = *reinterpret_cast<const uint4*>(kstep + (p * 32 + lane) * 16);
    b[2 * p][0] = v.x;
    b[2 * p][1] = v.y;
    b[2 * p + 1][0] = v.z;
    b[2 * p + 1][1] = v.w;
  }
}

// Copy `bytes` (a multiple of 16) from global to shared with cp.async.
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += TC_THREADS * 16) cp_async16(dst + i, src + i, 16);
}

// lane's row of the 8x8 matrix it addresses in ldmatrix.x4.trans: A rows
// are k = voxels 0-7 then 8-15 (matrices 0, 1 | 2, 3) at chunks +0, +1;
// B's are voxels 0-7, 8-15 at chunk 0, then at chunk 1
__device__ __forceinline__ int dw_a_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int dw_a_chunk(int lane) { return (lane >> 3) & 1; }
__device__ __forceinline__ int dw_b_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int dw_b_chunk(int lane) { return lane >> 4; }

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Opt in to the kernel's dynamic shared memory and size its grid: one
// block per tile when its weights stream, else as many blocks as fit on
// the card at once, each walking tiles.
template <typename K>
static unsigned grid_for(K kernel, int smem, long ntiles, bool resident,
                         int threads = TC_THREADS) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!resident) return (unsigned)ntiles;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long cap = (long)(per_sm > 0 ? per_sm : 1) * sm_count();
  return (unsigned)(ntiles < cap ? ntiles : cap);
}
