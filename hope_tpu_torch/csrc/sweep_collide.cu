// Swept car outline vs obstacle edges: any-intersection per (env, RS word).
//
// Replaces the Pallas TPU kernel hope_tpu/ops/sweep_collide.py:76
// (swept_collide, body _kernel :33). For env b and word k:
//
//   out[b, k] = any over car segment s (live) and scene edge e (live) of
//               the divide-free segment intersection test of (s, e)
//
// with p = car start, r = car end - p, q = edge start, s = edge end - q:
//   rxs = r x s, qpxs = (q - p) x s, qpxr = (q - p) x r
//   hit = qpxs*rxs >= 0 & |qpxs| <= |rxs| & qpxr*rxs >= 0 & |qpxr| <= |rxs|
//         & rxs != 0                   (parallel pairs excluded)
//
// What bounds it on an H100: at the battery's shapes (B = 256, K = 6 words,
// S = 4 x 288 car segments, E = 512 edges) the worst case is ~9e8 pair tests
// of ~20 float operations, ~1.8e10 operations: compute, not the ~9 MB of
// inputs. Most (env, word) pairs the planner asks about collide early, so the
// data-dependent work is far smaller.
//
// Design: one block per (env, word). The env's edges (start and direction
// precomputed) and mask go to shared memory. Threads own car segments and test
// them against a tile of edges; after each tile the block asks
// __syncthreads_or whether any thread hit, and stops if one did. Dead car
// segments and dead edges are skipped, which the plain version's masks make
// equivalent. The arithmetic is the plain version's, operation for operation;
// built with -fmad=false the result is bit-identical to it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int EDGE_TILE = 64;

__global__ void __launch_bounds__(THREADS)
swept_collide_kernel(const float4* __restrict__ car,
                     const uint8_t* __restrict__ car_live,
                     const float4* __restrict__ scene,
                     const uint8_t* __restrict__ scene_mask,
                     uint8_t* __restrict__ out, int K, int S, int E) {
  extern __shared__ float smem[];
  float* qx = smem;
  float* qy = smem + E;
  float* sx = smem + 2 * E;
  float* sy = smem + 3 * E;
  float* em = smem + 4 * E;

  const int bk = blockIdx.x;  // b * K + k
  const int b = bk / K;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const float4 se = scene[(size_t)b * E + e];
    qx[e] = se.x;
    qy[e] = se.y;
    sx[e] = se.z - se.x;
    sy[e] = se.w - se.y;
    em[e] = scene_mask[(size_t)b * E + e] ? 1.0f : 0.0f;
  }
  __syncthreads();

  const size_t base = (size_t)bk * S;
  int any = 0;
  for (int s0 = 0; s0 < S && !any; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    bool live = false;
    float px = 0.f, py = 0.f, rx = 0.f, ry = 0.f;
    if (s < S) {
      const float4 c = car[base + s];
      live = car_live[base + s] != 0;
      px = c.x;
      py = c.y;
      rx = c.z - c.x;
      ry = c.w - c.y;
    }
    int hit = 0;
    for (int e0 = 0; e0 < E; e0 += EDGE_TILE) {
      const int e1 = min(e0 + EDGE_TILE, E);
      if (live && !hit) {
        for (int e = e0; e < e1; ++e) {
          if (em[e] == 0.0f) continue;
          const float rxs = rx * sy[e] - ry * sx[e];
          const float qpx = qx[e] - px;
          const float qpy = qy[e] - py;
          const float qpxr = qpx * ry - qpy * rx;
          const float qpxs = qpx * sy[e] - qpy * sx[e];
          const float arxs = fabsf(rxs);
          if ((qpxs * rxs >= 0.0f) && (fabsf(qpxs) <= arxs) &&
              (qpxr * rxs >= 0.0f) && (fabsf(qpxr) <= arxs) && (rxs != 0.0f)) {
            hit = 1;
            break;
          }
        }
      }
      any = __syncthreads_or(hit);
      if (any) break;
    }
  }
  if (threadIdx.x == 0) out[bk] = any ? 1 : 0;
}

}  // namespace

extern "C" int swept_collide(const void* car, const void* car_live,
                             const void* scene, const void* scene_mask,
                             void* out, int B, int K, int S, int E,
                             void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const size_t smem = sizeof(float) * 5 * (size_t)(E > 0 ? E : 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swept_collide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  swept_collide_kernel<<<B * K, THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)car, (const uint8_t*)car_live, (const float4*)scene,
      (const uint8_t*)scene_mask, (uint8_t*)out, K, S, E);
  return (int)cudaGetLastError();
}
