// Action-mask collision horizon for a batch of envs.
//
// Replaces the Pallas TPU kernel hope_tpu/ops/mask_steps.py:50
// (mask_step_lengths, body _kernel :30). For every env b and action a:
//
//   up[j]     = x[j/U] * (1 - f) + x[(j/U + 1) % R] * f,   f = (j % U) / U
//   out[b, a] = min over (ray j, substep k) of (table[j, a, k] > up[j] ? k : I)
//
// where x = obs_ext[b] is the clipped, hull-extended lidar (R beams) and
// table is dist_star (R*U rays, A actions, I substeps), row-major.
//
// What bounds it on an H100: at the DLP battery's shapes (B = 256, R*U = 1200,
// A*I = 420) the work is 1.3e8 float32 compares on a 2 MB table that stays in
// L2 plus 120 KB of lidar: instruction throughput and the latency of the table
// loads, not bytes. A thread that walks all 1200 rays with one table load in
// flight takes ~0.18 ms whatever B is (measured from B = 8 to B = 1024 on an
// H100 80GB HBM3 at 700 W): the serial walk has to be short and its loads
// have to overlap.
//
// Design:
//  - The rays are split as well as the envs. A cluster of SLABS blocks owns
//    ENVS envs; each block of it owns one slab of ceil(R*U / SLABS) rays, so
//    B = 256 runs 256 blocks and a thread's serial walk is 150 rays, not
//    1200. A table column c = a*I + k belongs to one thread; the grid's z
//    dimension covers tables with more columns than a block has threads
//    (whole actions per block, so I <= THREADS is the one shape it refuses).
//  - For a fixed column the select yields only k or I, so
//    min over rays of (t > up ? k : I) == (any ray with t > up) ? k : I:
//    a predicate per (column, env), and k applied once at the end. The
//    predicate is kept as a sign: t > up exactly when up - t is negative
//    (IEEE subtraction without flush-to-zero never rounds a non-zero
//    difference to zero, x - x is +0, and a NaN operand gives the positive
//    canonical NaN, as `>` gives false; the one exception, -0 - +0 = -0, is
//    removed by storing up + 0.0f). So a compare costs one FADD and half
//    a three-input OR (two rays at a time into the env's accumulator)
//    instead of a compare, a select and a min. The ray loop is unrolled four
//    pairs deep, so a thread has eight table loads in flight; two pairs deep
//    it waited on L2 for most of its time.
//  - The block's slab of upsampled lidar lies in shared memory as [ray][env],
//    so a thread reads its 8 envs' values with two 16-byte broadcast loads
//    per table value. The upsample is fused and keeps the plain version's
//    operation order (lo = x[base]*(1-f), hi = x[nxt]*f, lo + hi).
//  - Each block leaves a byte of predicates per column in its own shared
//    memory; after a cluster barrier the cluster's first block ORs the SLABS
//    copies through distributed shared memory, finds the first blocked k of
//    every (env, action) and writes out. No atomics, no second launch, and
//    `any` is order-free, so the result is the plain version's bit for bit
//    (built with -fmad=false).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ENVS = 8;       // envs per cluster; one predicate bit each
constexpr int SLABS = 8;      // blocks per cluster = ray slabs (portable maximum)
constexpr int PAIRS = 4;      // ray pairs per unrolled loop body: 8 table loads in flight
constexpr int THREADS = 448;  // table columns per block; A*I = 420 by default

__global__ void __launch_bounds__(THREADS)
mask_step_lengths_kernel(const float* __restrict__ obs_ext,
                         const float* __restrict__ table,
                         float* __restrict__ out,
                         int B, int R, int U, int A, int I, int slab_rays,
                         int acts_per_block) {
  extern __shared__ float4 up4[];  // [slab_rays][ENVS] floats, two float4 per ray
  __shared__ unsigned char bits[THREADS];  // bit e of byte t: column t, env e

  cg::cluster_group cluster = cg::this_cluster();
  const int RU = R * U;
  const int cols = A * I;
  const int b0 = blockIdx.x * ENVS;
  const int r0 = blockIdx.y * slab_rays;
  const int nr = max(0, min(slab_rays, RU - r0));
  const int a0 = blockIdx.z * acts_per_block;
  const int na = min(acts_per_block, A - a0);
  const int t = threadIdx.x;

  float* up = reinterpret_cast<float*>(up4);
  for (int idx = t; idx < ENVS * nr; idx += THREADS) {
    const int r = idx / ENVS;
    const int e = idx - r * ENVS;
    const int b = b0 + e;
    const int j = r0 + r;
    float v = 0.0f;
    if (b < B) {
      const int base = j / U;
      const int nxt = (base + 1 == R) ? 0 : base + 1;
      const float f = (float)(j - base * U) / (float)U;
      const float* x = obs_ext + (size_t)b * R;
      const float lo = x[base] * (1.0f - f);
      const float hi = x[nxt] * f;
      v = lo + hi;
    }
    up[idx] = v + 0.0f;  // -0 becomes +0 (equal under `>`): see the sign form above
  }
  __syncthreads();

  // thread t owns column c = (a0 + a) * I + k with t = a * I + k < na * I
  unsigned mine = 0;
  if (t < na * I) {
    const float* tp = table + (size_t)r0 * cols + (size_t)a0 * I + t;
    int acc[ENVS];
#pragma unroll
    for (int e = 0; e < ENVS; ++e) acc[e] = 0;
    // two rays at a time, so that one three-input OR takes both
    int r = 0;
#pragma unroll PAIRS
    for (; r + 1 < nr; r += 2) {
      const float va = __ldg(tp + (size_t)r * cols);
      const float vb = __ldg(tp + (size_t)(r + 1) * cols);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 ua = up4[2 * r + q];
        const float4 ub = up4[2 * (r + 1) + q];
        acc[4 * q + 0] |= __float_as_int(ua.x - va) | __float_as_int(ub.x - vb);
        acc[4 * q + 1] |= __float_as_int(ua.y - va) | __float_as_int(ub.y - vb);
        acc[4 * q + 2] |= __float_as_int(ua.z - va) | __float_as_int(ub.z - vb);
        acc[4 * q + 3] |= __float_as_int(ua.w - va) | __float_as_int(ub.w - vb);
      }
    }
    if (r < nr) {  // an odd slab's last ray
      const float va = __ldg(tp + (size_t)r * cols);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 ua = up4[2 * r + q];
        acc[4 * q + 0] |= __float_as_int(ua.x - va);
        acc[4 * q + 1] |= __float_as_int(ua.y - va);
        acc[4 * q + 2] |= __float_as_int(ua.z - va);
        acc[4 * q + 3] |= __float_as_int(ua.w - va);
      }
    }
#pragma unroll
    for (int e = 0; e < ENVS; ++e) mine |= (unsigned)(acc[e] < 0) << e;
  }
  bits[t] = (unsigned char)mine;

  cluster.sync();  // every slab's predicates are in its block's shared memory
  if (cluster.block_rank() == 0) {
    unsigned all = mine;
    for (unsigned s = 1; s < cluster.num_blocks(); ++s)
      all |= cluster.map_shared_rank(bits, s)[t];
    bits[t] = (unsigned char)all;  // byte t is read and written by thread t alone
    __syncthreads();
    for (int idx = t; idx < ENVS * na; idx += THREADS) {
      const int e = idx / na;
      const int a = idx - e * na;
      const int b = b0 + e;
      if (b >= B) continue;
      int k = 0;
      while (k < I && !((bits[a * I + k] >> e) & 1)) ++k;
      out[(size_t)b * A + a0 + a] = (float)k;
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its shared memory
}

}  // namespace

extern "C" int mask_step_lengths(const void* obs_ext, const void* table,
                                 void* out, int B, int R, int U, int A, int I,
                                 void* stream) {
  if (B <= 0 || A <= 0) return 0;
  if (I <= 0 || I > THREADS || R <= 0 || U <= 0) return (int)cudaErrorInvalidValue;
  const int RU = R * U;
  const int slab_rays = (RU + SLABS - 1) / SLABS;
  const int acts_per_block = THREADS / I < A ? THREADS / I : A;
  const size_t smem = sizeof(float) * ENVS * (size_t)slab_rays;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mask_step_lengths_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + ENVS - 1) / ENVS, SLABS,
                     (A + acts_per_block - 1) / acts_per_block);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = SLABS;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, mask_step_lengths_kernel, (const float*)obs_ext, (const float*)table,
      (float*)out, B, R, U, A, I, slab_rays, acts_per_block);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
