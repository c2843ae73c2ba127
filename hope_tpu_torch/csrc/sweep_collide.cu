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
// What bounds it on an H100: operations, and the order they are done in. At
// the battery's shapes (B = 256, K = 6 words, S = 4 x 288 car segments,
// E = 512 edge slots, ~300 of them live) the worst case is ~9e8 pair tests of
// ~20 float operations against ~9 MB of inputs. Most words collide and need
// only the tests up to their first hit. Where that lies depends on the poses:
// from poses between start and goal (chip_smoke.py's kernel phase) half of
// the colliding words hit within their first pose; in the battery's own early
// steps (its phase kernel_real_step) 94% collide, half of them only after
// segment ~180 of ~800 live ones; once the episodes have ended the paths are
// short (~210 live segments) and two thirds of them clear. In each case the
// needed tests are a small part of the worst case, and the walk must follow
// the path and stop early. Testing a wide
// slab of segments at once makes a word that collides at its first segment
// pay for the whole slab, and spreading a word over blocks that all start
// together (measured) makes every slab work until the first one hits: the
// wasted tests fill the card.
//
// Design: one block of 8 warps per word, and
//  - the path is walked in order, in stages that double: segments [0, 32),
//    [32, 64), [64, 128), ... each as wide as the path walked so far, up to
//    one segment per thread, with a block vote after each. A word that
//    collides at segment s tests at most about 2s segments, and one that is
//    clear pays a few extra barriers. A stage narrower than the block gives
//    each group of 32 segments several warps, which share its edge tiles, so
//    no warp idles in the stages that nearly every word ends in;
//  - dead edge slots are dropped while loading: the block compacts the env's
//    live edges (start and direction) into shared memory, 16 bytes an edge;
//  - a broad phase drops most edges for a whole warp before any pair is
//    tested. It needs no margin: see the comment at it for why it can only
//    drop pairs that the exact test rejects;
//  - a warp votes after every tile of 32 edges (__any_sync, no block
//    barrier) and leaves the stage at its first hit; the other warps see a
//    flag in shared memory at their next tile;
//  - the block walks only up to the word's last live segment.
// `any` is order-free and the pairs that survive the broad phase run the
// plain version's arithmetic, operation for operation; built with
// -fmad=false the result is bit-identical to it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // the widest stage: one car segment per thread
constexpr int WARPS = THREADS / 32;
constexpr int EDGE_TILE = 32;  // live edges between two votes, one per lane
constexpr int UNROLL = 4;      // kept edges tested together
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
swept_collide_kernel(const float4* __restrict__ car,
                     const uint8_t* __restrict__ car_live,
                     const float4* __restrict__ scene,
                     const uint8_t* __restrict__ scene_mask,
                     uint8_t* __restrict__ out, int K, int S, int E) {
  extern __shared__ float4 sedge[];  // live edges: (qx, qy, sx, sy)
  __shared__ int n_live_s;           // live edges
  __shared__ int s_end_s;            // one past the last live car segment
  __shared__ int found_s;            // a warp of this block has hit

  const int bk = blockIdx.x;  // b * K + k
  const int b = bk / K;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)bk * S;
  volatile int* found = &found_s;

  if (threadIdx.x == 0) {
    n_live_s = 0;
    s_end_s = 0;
    found_s = 0;
  }
  __syncthreads();
  int last = 0;
  for (int s = threadIdx.x; s < S; s += THREADS)
    if (car_live[base + s] != 0) last = s + 1;
  last = __reduce_max_sync(FULL, last);
  if (lane == 0 && last) atomicMax(&s_end_s, last);
  // dead edge slots are dropped here; the order of the live ones is free
  for (int e0 = 0; e0 < E; e0 += THREADS) {
    const int e = e0 + threadIdx.x;
    const bool m = e < E && scene_mask[(size_t)b * E + e] != 0;
    const unsigned bal = __ballot_sync(FULL, m);
    int slot = 0;
    if (lane == 0 && bal) slot = atomicAdd(&n_live_s, __popc(bal));
    slot = __shfl_sync(FULL, slot, 0) + __popc(bal & ((1u << lane) - 1u));
    if (m) {
      const float4 se = scene[(size_t)b * E + e];
      sedge[slot] = make_float4(se.x, se.y, se.z - se.x, se.w - se.y);
    }
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int s_end = n_live > 0 ? s_end_s : 0;

  // Stages in path order: [0, 32), [32, 64), [64, 128), ... each as wide as
  // the path walked so far, up to one segment per thread. A stage narrower
  // than the block gives each group of 32 segments several warps, which
  // share the group's edge tiles.
  const int warp = threadIdx.x >> 5;
  for (int lo = 0; lo < s_end;) {
    const int hi = min(lo + min(max(lo, 32), THREADS), s_end);
    const int groups = (hi - lo + 31) >> 5;
    const int share = WARPS / groups;       // warps per group
    const int part = warp / groups;         // this warp's share of the tiles
    const int s = lo + 32 * (warp % groups) + lane;
    const bool live = part < share && s < hi && car_live[base + s] != 0;
    bool warp_hit = false;
    if (__any_sync(FULL, live)) {
      float px = 0.f, py = 0.f, rx = 0.f, ry = 0.f;
      if (live) {
        const float4 c = car[base + s];
        px = c.x;
        py = c.y;
        rx = c.z - c.x;
        ry = c.w - c.y;
      }
      // the warp's live segments: box of their starts, largest |r| components
      const float inf = __int_as_float(0x7f800000);
      float px_lo = live ? px : inf, px_hi = live ? px : -inf;
      float py_lo = live ? py : inf, py_hi = live ? py : -inf;
      float rx_max = live ? fabsf(rx) : 0.f, ry_max = live ? fabsf(ry) : 0.f;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        px_lo = fminf(px_lo, __shfl_xor_sync(FULL, px_lo, d));
        px_hi = fmaxf(px_hi, __shfl_xor_sync(FULL, px_hi, d));
        py_lo = fminf(py_lo, __shfl_xor_sync(FULL, py_lo, d));
        py_hi = fmaxf(py_hi, __shfl_xor_sync(FULL, py_hi, d));
        rx_max = fmaxf(rx_max, __shfl_xor_sync(FULL, rx_max, d));
        ry_max = fmaxf(ry_max, __shfl_xor_sync(FULL, ry_max, d));
      }
      for (int e0 = part * EDGE_TILE; e0 < n_live; e0 += share * EDGE_TILE) {
        if (__any_sync(FULL, *found != 0)) break;  // another warp has hit
        // Broad phase, one edge per lane: can any live segment of this warp
        // pass the exact test's |qpxs| <= |rxs| against this edge? Float add,
        // subtract and multiply are monotone in each operand, so evaluating
        // the exact test's own operations at the ends of the group's ranges
        // encloses every segment's computed value, rounding included, with
        // no margin to choose:
        //   |rxs| = |rx*sy - ry*sx| <= rx_max*|sy| + ry_max*|sx| = bound
        //   qpxs  = (qx-px)*sy - (qy-py)*sx  lies in [d_lo, d_hi]
        // The edge is dropped only if [d_lo, d_hi] lies outside
        // [-bound, bound], and then the exact test rejects every pair of it.
        // A NaN in any of these compares false and keeps the edge. (This
        // too needs -fmad=false: a fused bound could round below |rxs|.)
        bool keep = false;
        if (e0 + lane < n_live) {
          const float4 ed = sedge[e0 + lane];
          const float bound = rx_max * fabsf(ed.w) + ry_max * fabsf(ed.z);
          const float ax = (ed.x - px_hi) * ed.w, bx = (ed.x - px_lo) * ed.w;
          const float ay = (ed.y - py_hi) * ed.z, by = (ed.y - py_lo) * ed.z;
          const float a_lo = ed.w >= 0.f ? ax : bx, a_hi = ed.w >= 0.f ? bx : ax;
          const float b_lo = ed.z >= 0.f ? ay : by, b_hi = ed.z >= 0.f ? by : ay;
          const float d_lo = a_lo - b_hi, d_hi = a_hi - b_lo;
          keep = !(d_lo > bound) && !(d_hi < -bound);
        }
        unsigned todo = __ballot_sync(FULL, keep);
        bool hit = false;
        // exact test, UNROLL kept edges at a time so that their dependent
        // chains overlap; when fewer are left the tile's first edge fills in
        // (testing a live edge again changes nothing)
        while (todo) {
          float4 ed[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            ed[u] = sedge[e0 + max(__ffs(todo) - 1, 0)];
            todo &= todo - 1;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const float rxs = rx * ed[u].w - ry * ed[u].z;
            const float qpx = ed[u].x - px;
            const float qpy = ed[u].y - py;
            const float qpxr = qpx * ry - qpy * rx;
            const float qpxs = qpx * ed[u].w - qpy * ed[u].z;
            const float arxs = fabsf(rxs);
            hit |= (qpxs * rxs >= 0.0f) && (fabsf(qpxs) <= arxs) &&
                   (qpxr * rxs >= 0.0f) && (fabsf(qpxr) <= arxs) && (rxs != 0.0f);
          }
        }
        if (__any_sync(FULL, hit && live)) {
          warp_hit = true;
          if (lane == 0) *found = 1;
          break;
        }
      }
    }
    if (__syncthreads_or(warp_hit)) {
      if (threadIdx.x == 0) out[bk] = 1;
      return;
    }
    lo = hi;
  }
  if (threadIdx.x == 0) out[bk] = 0;
}

}  // namespace

extern "C" int swept_collide(const void* car, const void* car_live,
                             const void* scene, const void* scene_mask,
                             void* out, int B, int K, int S, int E,
                             void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const size_t smem = sizeof(float4) * (size_t)E;
  // 227 KB a block, less the kernel's static words
  if (smem > 227 * 1024 - 64) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swept_collide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * K);
  swept_collide_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)car, (const uint8_t*)car_live, (const float4*)scene,
      (const uint8_t*)scene_mask, (uint8_t*)out, K, S, E);
  return (int)cudaGetLastError();
}
