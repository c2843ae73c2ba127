// Ego-frame BEV image, one launch per call: edge preparation and culling,
// crossing parity per (edge, image row), dest and car quads, class and
// palette, one env per block.
//
// Replaces the Pallas TPU kernel hope_tpu/ops/raster_bev.py:306
// (render_bev_batch: body _kernel :66 via _raster_classes :260, with the
// edge preparation _ego_edge_params :181 and _quad_coeffs :242 that ran as
// XLA ops around it). For env b with pose (x, y, th) and pixel (i, j) of an
// n x n image, h = (n - 1) / 2:
//
//   c = cos th, s = sin th, cx = x + c*cx_off, cy = y + s*cx_off
//   edge e, ego frame:  v = c*dx + s*dy, u = (-s)*dx + c*dy (dx, dy from cx, cy)
//                       su = (u2-u1) / (dv == 0 ? 1 : dv), uc = u1 - v1*su
//   kept:  live (mask and dv != 0) and not DROP (its v-interval misses the
//          image, or it lies entirely left of it); RIGHT: entirely right
//   pixel: v_i = (h - i)*res, u_j = (j - h)*res
//   edge crosses the pixel's +u ray <=> (v1 > v_i) != (v2 > v_i)
//                                       and u_j < v_i*su + uc
//   obstacle: exact mode -- a polygon's crossing count is odd, for any
//             polygon; global mode -- the count over all kept edges is odd,
//             a RIGHT edge counting where it straddles the row alone
//   dest / car: all four half-planes (c0*v + c1*u) + c2 >= 0 hold
//   class: car 3 > dest 2 > obstacle 1 > background 0; out = palette[class]
//
// Every float operation is the plain version's (ops/raster_bev.py,
// ego_edge_params -> quad_coeffs -> raster_bev_plain), in its order; built
// with -fmad=false and IEEE division the image is bit-identical to it. The
// plain version's min / max tests are written as conjunctions of compares,
// which give the same answer for NaN (false) as torch.minimum's NaN does.
//
// What bounds it on an H100: bytes, the image write. At the battery's shapes
// (B = 256, E = 512 slots, n = 64) the call reads 2.8 MB of edges, masks and
// ids and writes a 12.6 MB image (~4.6 us at 3.35 TB/s); the work the data
// needs is below 1e8 operations: ~30 a slot to prepare and cull, ~105 kept
// edges an env that straddle ~6 of the 64 rows each (~630 crossings an
// env), and 8 half-planes a pixel. All blocks start together and run the
// same phases, so the card writes only in the last one; the design keeps
// the phases before it short.
//
// Design (one block of 256 threads per env):
//  - thread e prepares edge slot e with the plain version's operations; the
//    block compacts the kept edges into shared memory in storage order
//    (ballot + per-warp counts);
//  - exact mode needs the edges of one polygon together. The block checks
//    that the kept edges' ids do not decrease (true of every DLP and
//    procedural scene seen) and only otherwise sorts them by (id, position)
//    by rank into a second buffer. The ids are never used as an index;
//  - crossings per (edge, row), only where the edge straddles the row. Each
//    kept edge finds the rows it straddles, [lo, hi), from the plain
//    compares (v_i decreases with i, so the rows with v1 > v_i are a
//    suffix, found by an estimate and the exact compares). The work items
//    are (polygon, row) pairs in exact mode and (edge, row) pairs in global
//    mode, spread over the block by a scan. An item computes, for each of
//    its edges that straddles the row, ui = v_i*su + uc once and J, the
//    number of columns with u_j < ui, again by an estimate and the exact
//    compares (the u_j increase with j, so the crossing columns are
//    [0, J); NaN gives 0, +inf n, -inf 0, as `<` does), XORs the first J
//    bits into a 64-bit row word, and ORs the word (exact: any polygon odd)
//    or XORs it (global; a RIGHT edge toggles the whole row) into the row's
//    obstacle word with a shared-memory atomic. On the battery's inputs that
//    is ~630 crossings an env, against 4096 pixels x ~105 edges;
//  - the image leaves 32 pixels a warp at a time: each lane evaluates one
//    pixel's quads and takes its obstacle bit, and 24 lanes store the 96
//    floats as consecutive 16-byte stores, reading the two classes they need
//    by shuffle; the palette comes in as a kernel argument.
// Measured on the way (chip_smoke.py's inputs, B = 256, an H100 80GB HBM3 at
// 700 W): a thread per image row walking all kept edges took 4x as long,
// several threads per row 1.5x; a warp per polygon with lanes over its rows
// lost to the scan-spread items in both modes.
#include <cstdint>
#include <cuda_runtime.h>

// the palette, by value (outside the unnamed namespace: the C entry point
// takes it, and must keep external linkage)
struct Palette {
  float c[12];  // background, obstacle, dest, car; r, g, b each
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// shared memory a block can use, less what the kernel declares statically
// (row words, quads, palette, warp counts: under 2.5 KB); the wrapper
// states the same as MAX_EDGES
constexpr int DYN_SMEM_MAX = 227 * 1024 - 2560;

// bits [0, J) of row word w (columns 64w .. 64w + 63)
__device__ __forceinline__ uint64_t prefix_bits(int J, int w) {
  const int k = J - 64 * w;
  return k <= 0 ? 0ull : (k >= 64 ? ~0ull : ((1ull << k) - 1ull));
}

// #{j < N : u_j < x} for the column coordinates u_j = (j - half) * res,
// which increase with j: an estimate from x / res, then the exact compares
// settle it (u_(e-1) < x, or e = 0; not u_e < x, or e = N). NaN gives 0
// (fmaxf drops it, and no compare holds), +inf N, -inf 0.
template <int N>
__device__ __forceinline__ int count_below(float x, float half, float res, float inv_res) {
  int e = (int)fminf(fmaxf(floorf(x * inv_res + half) + 1.0f, 0.0f), (float)N);
  while (e > 0 && !(((float)(e - 1) - half) * res < x)) --e;
  while (e < N && ((float)e - half) * res < x) ++e;
  return e;
}

// the first row i < N with a > v_i for the row coordinates
// v_i = (half - i) * res, which decrease with i (N where there is none; so
// a NaN gives N)
template <int N>
__device__ __forceinline__ int first_above(float a, float half, float res, float inv_res) {
  int e = (int)fminf(fmaxf(floorf(half - a * inv_res) + 1.0f, 0.0f), (float)N);
  while (e > 0 && a > (half - (float)(e - 1)) * res) --e;
  while (e < N && !(a > (half - (float)e) * res)) ++e;
  return e;
}

// exclusive prefix sum of x over the block's threads; the block's total in
// `total`. All threads call it; wsum holds WARPS ints.
__device__ __forceinline__ int block_excl_scan(int x, int* wsum, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int k = wsum[w];
    before += w < warp ? k : 0;
    total += k;
  }
  __syncthreads();  // wsum is reused
  return before + incl - x;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
raster_bev_kernel(const float* __restrict__ poses, const float* __restrict__ vboxes,
                  const float* __restrict__ dboxes, const float4* __restrict__ edges,
                  const uint8_t* __restrict__ edge_mask, const int* __restrict__ edge_poly,
                  float4* __restrict__ out, int E, float res, float cx_off, int exact,
                  Palette pal) {
  constexpr int W = (N + 63) / 64;       // 64-bit words per image row
  constexpr int LOG_N = N == 16 ? 4 : N == 32 ? 5 : N == 64 ? 6 : 7;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* prm = reinterpret_cast<float4*>(smem);  // [E] kept edges: v1, v2, su, uc
  float4* prm2 = prm + E;                         // [E] the same sorted by id
  int* key = reinterpret_cast<int*>(prm2 + E);    // [E] polygon id, or RIGHT (global)
  int* key2 = key + E;
  int* rng = key2 + E;                            // [E] rows straddled, lo | hi << 16
  int* grow = rng + E;                            // [E] a group's first row
  int* gfirst = grow + E;                         // [E + 1] a group's first edge
  int* ibase = gfirst + E + 1;                    // [E + 1] a group's first item
  __shared__ uint64_t obst_s[N * W];
  __shared__ float quad_s[8][3];
  __shared__ float pal_s[12];
  __shared__ int wcnt_s[WARPS];
  __shared__ int wsum_s[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float th = poses[3 * b + 2];
  const float c = cosf(th);
  const float s = sinf(th);
  const float cx = poses[3 * b] + c * cx_off;
  const float cy = poses[3 * b + 1] + s * cx_off;
  const float half = 0.5f * (float)(N - 1);
  const float ext = half * res;  // the outermost pixel's coordinate
  const float inv_res = 1.0f / res;  // for estimates only

  if (tid < 8) {  // half-planes: dest quad, then car quad
    const float* q = (tid < 4 ? dboxes : vboxes) + (size_t)b * 8;
    const int k = tid & 3;
    const int k1 = (k + 1) & 3;
    const float ax = q[2 * k], ay = q[2 * k + 1];
    const float ex = q[2 * k1] - ax;
    const float ey = q[2 * k1 + 1] - ay;
    quad_s[tid][0] = ex * s - ey * c;
    quad_s[tid][1] = ex * c + ey * s;
    quad_s[tid][2] = ex * (cy - ay) - ey * (cx - ax);
  }
  if (tid < 12) pal_s[tid] = pal.c[tid];

  // prepare, cull and compact the edge slots, keeping storage order
  int nk = 0;
  for (int e0 = 0; e0 < E; e0 += THREADS) {
    const int e = e0 + tid;
    bool kept = false;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    int id = 0;
    if (e < E) {
      const size_t at = (size_t)b * E + e;
      const float4 ed = edges[at];
      const float dx1 = ed.x - cx, dy1 = ed.y - cy;
      const float dx2 = ed.z - cx, dy2 = ed.w - cy;
      const float v1 = c * dx1 + s * dy1;
      const float u1 = (-s) * dx1 + c * dy1;
      const float v2 = c * dx2 + s * dy2;
      const float u2 = (-s) * dx2 + c * dy2;
      const float dv = v2 - v1;
      const float su = (u2 - u1) / (dv == 0.0f ? 1.0f : dv);
      const float uc = u1 - v1 * su;
      const bool live = edge_mask[at] != 0 && dv != 0.0f;
      kept = live && !(v1 > ext && v2 > ext)        // above the image
             && !(v1 <= -ext && v2 <= -ext)         // below it
             && !(u1 <= -ext && u2 <= -ext);        // entirely left
      p = make_float4(v1, v2, su, uc);
      id = exact ? edge_poly[at] : (int)(u1 > ext && u2 > ext);  // RIGHT
    }
    const unsigned bal = __ballot_sync(FULL, kept);
    if (lane == 0) wcnt_s[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int k = wcnt_s[w];
      before += w < warp ? k : 0;
      total += k;
    }
    if (kept) {
      const int slot = nk + before + __popc(bal & ((1u << lane) - 1u));
      prm[slot] = p;
      key[slot] = id;
    }
    nk += total;
    __syncthreads();  // wcnt_s is reused; prm and key are complete
  }

  // exact mode: one polygon's edges together. Sorted ids need nothing;
  // otherwise a stable sort by rank, (id, position), into the second buffer
  const float4* P = prm;
  const int* K = key;
  if (exact) {
    bool unsorted = false;
    for (int k = tid; k + 1 < nk; k += THREADS) unsorted |= key[k] > key[k + 1];
    if (__syncthreads_or(unsorted)) {
      for (int k = tid; k < nk; k += THREADS) {
        const int id = key[k];
        int r = 0;
        for (int j = 0; j < nk; ++j) {
          const int o = key[j];
          r += (o < id) || (o == id && j < k);
        }
        prm2[r] = prm[k];
        key2[r] = id;
      }
      P = prm2;
      K = key2;
    }
  }
  __syncthreads();  // the quads, the palette, the sorted copy

  // 1. the rows each kept edge straddles: [lo, hi), from the plain compares
  //    (v_i decreases with i, so the rows with A > v_i are [first_above(A), N))
  for (int k = tid; k < nk; k += THREADS) {
    const float4 p = P[k];
    const int ia = first_above<N>(p.x, half, res, inv_res);
    const int ib = first_above<N>(p.y, half, res, inv_res);
    rng[k] = min(ia, ib) | (max(ia, ib) << 16);
  }
  for (int i = tid; i < N * W; i += THREADS) obst_s[i] = 0ull;

  // 2. groups: one polygon's edges (exact), or each edge alone (global); a
  //    group's first edge, in order, by a scan of the start flags
  int ng = 0;
  for (int k0 = 0; k0 < nk; k0 += THREADS) {
    const int k = k0 + tid;
    const bool start = k < nk && (!exact || k == 0 || K[k - 1] != K[k]);
    int total;
    const int g = ng + block_excl_scan((int)start, wsum_s, total);
    if (start) gfirst[g] = k;
    ng += total;
  }
  if (tid == 0) gfirst[ng] = nk;
  __syncthreads();

  // 3. a group's rows: the union of its edges' ranges; its items, one per
  //    (group, row), numbered by a scan
  int n_items = 0;
  for (int g0 = 0; g0 < ng; g0 += THREADS) {
    const int g = g0 + tid;
    int len = 0;
    if (g < ng) {
      int lo = N, hi = 0;
      for (int k = gfirst[g]; k < gfirst[g + 1]; ++k) {
        const int r = rng[k];
        if ((r & 0xffff) < (r >> 16)) {
          lo = min(lo, r & 0xffff);
          hi = max(hi, r >> 16);
        }
      }
      len = max(hi - lo, 0);
      grow[g] = lo;
    }
    int total;
    const int at = n_items + block_excl_scan(len, wsum_s, total);
    if (g < ng) ibase[g] = at;
    n_items += total;
  }
  __syncthreads();

  // 4. the items: row i's word for one group, the group's straddling edges
  //    XORed in; then ORed (exact: any polygon odd) or XORed (global) into
  //    the row's obstacle word
  for (int t = tid; t < n_items; t += THREADS) {
    int lo = 0, hi = ng;  // the last group whose items start at or before t
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (ibase[mid] <= t) lo = mid;
      else hi = mid;
    }
    const int g = lo;
    const int i = grow[g] + (t - ibase[g]);
    const float v = (half - (float)i) * res;
    uint64_t word[W];
#pragma unroll
    for (int w = 0; w < W; ++w) word[w] = 0ull;
    for (int k = gfirst[g]; k < gfirst[g + 1]; ++k) {
      const int r = rng[k];
      if (i < (r & 0xffff) || i >= (r >> 16)) continue;  // does not straddle row i
      int J = N;  // a RIGHT edge in global mode: the straddle test alone
      if (exact || K[k] == 0) {
        const float4 p = P[k];
        const float vs = v * p.z;
        J = count_below<N>(vs + p.w, half, res, inv_res);
      }
#pragma unroll
      for (int w = 0; w < W; ++w) word[w] ^= prefix_bits(J, w);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (word[w] == 0ull) continue;
      unsigned long long* dst = reinterpret_cast<unsigned long long*>(&obst_s[i * W + w]);
      if (exact) atomicOr(dst, (unsigned long long)word[w]);
      else atomicXor(dst, (unsigned long long)word[w]);
    }
  }
  __syncthreads();

  // The image, (N, N, 3) floats, 32 pixels a warp at a time: each lane finds
  // one pixel's class (quads, then the obstacle bit), and 24 lanes store the
  // 96 floats as 16-byte stores, taking the two classes they need by shuffle
  float4* o = out + (size_t)b * (N * N * 3 / 4);
  for (int px0 = warp * 32; px0 < N * N; px0 += THREADS) {
    const int px = px0 + lane;
    const int i = px >> LOG_N;
    const int j = px & (N - 1);
    const float v = (half - (float)i) * res;
    const float u = ((float)j - half) * res;
    bool in[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      bool inside = true;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float* cq = quad_s[4 * q + h];
        const float a0 = cq[0] * v;
        const float a1 = cq[1] * u;
        const float s01 = a0 + a1;
        inside = inside && (s01 + cq[2] >= 0.0f);
      }
      in[q] = inside;
    }
    const int cl = in[1] ? 3 : (in[0] ? 2 : (int)((obst_s[i * W + (j >> 6)] >> (j & 63)) & 1ull));
    const int p0 = (4 * lane) / 3;            // this lane's float4: pixels p0, p0 + 1
    const int r = 4 * lane - 3 * p0;          // the first float's channel
    const int c0 = __shfl_sync(FULL, cl, min(p0, 31));
    const int c1 = __shfl_sync(FULL, cl, min(p0 + 1, 31));
    if (lane < 24) {
      float f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = r + k;
        f[k] = ch < 3 ? pal_s[c0 * 3 + ch] : pal_s[c1 * 3 + ch - 3];
      }
      o[(px0 / 4) * 3 + lane] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

template <int N>
int launch(const void* poses, const void* vboxes, const void* dboxes, const void* edges,
           const void* edge_mask, const void* edge_poly, void* out, int B, int E,
           float res, float cx_off, int exact, Palette pal, cudaStream_t stream) {
  const size_t smem = (size_t)E * 2 * (sizeof(float4) + sizeof(int)) +
                      (size_t)(4 * E + 2) * sizeof(int);
  if (smem > (size_t)DYN_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_bev_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  raster_bev_kernel<N><<<B, THREADS, smem, stream>>>(
      (const float*)poses, (const float*)vboxes, (const float*)dboxes,
      (const float4*)edges, (const uint8_t*)edge_mask, (const int*)edge_poly,
      (float4*)out, E, res, cx_off, exact, pal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int render_bev_batch(const void* poses, const void* vboxes, const void* dboxes,
                                const void* edges, const void* edge_mask,
                                const void* edge_poly, void* out, int B, int E, int n,
                                float res, float cx_off, int exact, Palette pal,
                                void* stream) {
  if (B <= 0) return 0;
  if (E < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 16: return launch<16>(poses, vboxes, dboxes, edges, edge_mask, edge_poly, out, B, E,
                               res, cx_off, exact, pal, st);
    case 32: return launch<32>(poses, vboxes, dboxes, edges, edge_mask, edge_poly, out, B, E,
                               res, cx_off, exact, pal, st);
    case 64: return launch<64>(poses, vboxes, dboxes, edges, edge_mask, edge_poly, out, B, E,
                               res, cx_off, exact, pal, st);
    case 128: return launch<128>(poses, vboxes, dboxes, edges, edge_mask, edge_poly, out, B, E,
                                 res, cx_off, exact, pal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
