// Ego-frame BEV image: crossing-parity obstacle test, dest and car quads,
// class composition and palette, one env per block.
//
// Replaces the Pallas TPU kernel hope_tpu/ops/raster_bev.py:306
// (render_bev_batch; class-map body _kernel :66 via _raster_classes :260).
// The edge preparation (_ego_edge_params) and the quad coefficients stay
// PyTorch ops around this kernel, as they stayed XLA ops around the Pallas
// call. For env b and pixel (i, j) of an n x n image:
//
//   v = (h - i) * res, u = (j - h) * res, h = (n - 1) / 2   (forward, right)
//   edge e crosses the pixel's +u ray  <=>  (A_e > v) != (B_e > v)
//                                           and u < v * S_e + C_e
//   obstacle: exact mode (P = 5) -- edges come grouped by polygon, row 4 flags
//             each polygon's last edge; a pixel is inside if the crossing
//             count of any polygon is odd. Global mode (P = 4) -- the count
//             over the first nf edges plus the straddle test of the next ns
//             edges (which lie right of the image) is odd.
//   dest / car: all four half-planes q0*v + q1*u + q2 >= 0 hold
//   class: car 3 > dest 2 > obstacle 1 > background 0; out = palette[class]
//
// What bounds it on an H100: compute. With no culling the crossing test is
// 4096 pixels x 512 edges x ~7 operations per env (3.8e9 at B = 256); the
// edge preparation drops the edges that cannot reach the image, so the
// data-dependent work is a few per cent of that. Bytes are small: ~10 KB of
// edge parameters in and 48 KB of image out per env.
//
// Design: one block per env. The env's live edge parameters (the first
// nf + ns columns) go to shared memory; each thread owns PIX pixels and walks
// the live edges once, testing all its pixels against each edge read. The
// arithmetic is the plain version's, operation for operation; built with
// -fmad=false the result is bit-identical to it.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 16;  // pixels per thread per pass: THREADS * PIX = 64 * 64

__global__ void __launch_bounds__(THREADS)
raster_bev_kernel(const float* __restrict__ params, const int* __restrict__ cnt,
                  const float* __restrict__ quads, const float* __restrict__ palette,
                  float* __restrict__ out, int P, int E, int n, float res) {
  extern __shared__ float smem[];  // [P][nlive]
  __shared__ float q[8 * 4];
  __shared__ float pal[4 * 3];
  const int b = blockIdx.x;
  const int nf = cnt[2 * b];
  const int ns = cnt[2 * b + 1];
  const int nlive = nf + ns;
  const bool exact = (P == 5);

  for (int i = threadIdx.x; i < P * nlive; i += blockDim.x) {
    const int p = i / nlive;
    const int e = i - p * nlive;
    smem[i] = params[((size_t)b * P + p) * E + e];
  }
  if (threadIdx.x < 32) q[threadIdx.x] = quads[(size_t)b * 32 + threadIdx.x];
  if (threadIdx.x < 12) pal[threadIdx.x] = palette[threadIdx.x];
  __syncthreads();

  const float* pA = smem;
  const float* pB = smem + nlive;
  const float* pS = smem + 2 * nlive;
  const float* pC = smem + 3 * nlive;
  const float* pF = smem + 4 * nlive;  // exact mode only
  const float half = 0.5f * (float)(n - 1);
  const int npx = n * n;

  for (int p0 = 0; p0 < npx; p0 += THREADS * PIX) {
    float v[PIX], u[PIX];
    int par[PIX], obst[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int p = p0 + threadIdx.x + k * THREADS;
      const int i = p / n;
      const int j = p - i * n;
      v[k] = (half - (float)i) * res;
      u[k] = ((float)j - half) * res;
      par[k] = 0;
      obst[k] = 0;
    }
    for (int e = 0; e < nf; ++e) {
      const float A = pA[e], Bv = pB[e], S = pS[e], C = pC[e];
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        const bool straddle = (A > v[k]) != (Bv > v[k]);
        const float vs = v[k] * S;
        const float ui = vs + C;
        par[k] ^= (straddle && (u[k] < ui)) ? 1 : 0;
      }
      if (exact && pF[e] != 0.0f) {
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
          obst[k] |= par[k];
          par[k] = 0;
        }
      }
    }
    if (!exact) {
      for (int e = nf; e < nlive; ++e) {
        const float A = pA[e], Bv = pB[e];
#pragma unroll
        for (int k = 0; k < PIX; ++k) par[k] ^= ((A > v[k]) != (Bv > v[k])) ? 1 : 0;
      }
#pragma unroll
      for (int k = 0; k < PIX; ++k) obst[k] = par[k];
    }

#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int p = p0 + threadIdx.x + k * THREADS;
      if (p >= npx) continue;
      bool inq[2];
      for (int w = 0; w < 2; ++w) {
        bool inside = true;
        for (int h = 0; h < 4; ++h) {
          const float* c = q + (w * 4 + h) * 4;
          const float a0 = c[0] * v[k];
          const float a1 = c[1] * u[k];
          const float s01 = a0 + a1;
          inside = inside && (s01 + c[2] >= 0.0f);
        }
        inq[w] = inside;
      }
      const int cls = inq[1] ? 3 : (inq[0] ? 2 : (obst[k] ? 1 : 0));
      float* o = out + ((size_t)b * npx + p) * 3;
      o[0] = pal[cls * 3 + 0];
      o[1] = pal[cls * 3 + 1];
      o[2] = pal[cls * 3 + 2];
    }
  }
}

}  // namespace

extern "C" int raster_bev(const void* params, const void* cnt, const void* quads,
                          const void* palette, void* out, int B, int P, int E,
                          int n, float res, void* stream) {
  if (B <= 0) return 0;
  if (P != 4 && P != 5) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)P * (E > 0 ? E : 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_bev_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  raster_bev_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)params, (const int*)cnt, (const float*)quads,
      (const float*)palette, (float*)out, P, E, n, res);
  return (int)cudaGetLastError();
}
