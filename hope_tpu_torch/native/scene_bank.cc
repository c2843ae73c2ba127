// Host-side scene-bank runtime: mmap'd case storage + threaded batch gather.
//
// The reference framework's "data loader" is a Python pickle of shapely
// geometries unpickled per construction (env/parking_map_dlp.py:31-36); the
// TPU framework stores case banks as a flat binary layout (written by
// hope_tpu.native.convert_npz_to_bank) that memory-maps in O(1), and batch
// assembly (gather + truncate-to-runtime-budget) runs on a C++ thread pool
// with an async prefetch lane so host batch prep overlaps device compute.
//
// Layout (HTPB1): header of int64 [magic, n_cases, E, S] followed by
//   edges    f32 [C, E, 4]
//   edge_mask u8 [C, E]
//   edge_poly i32[C, E]
//   n_polys  i32[C]
//   dest     f32 [C, 3]
//   starts   f32 [C, S, 3]
//   n_starts i32[C]
//   levels   i32[C, S]
//
// Build: make -C hope_tpu/native  (see __init__.py, which builds on demand).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kMagic = 0x3142505448LL;  // "HTPB1" little-endian

struct Bank {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  int64_t C = 0, E = 0, S = 0;
  const float* edges = nullptr;
  const uint8_t* edge_mask = nullptr;
  const int32_t* edge_poly = nullptr;
  const int32_t* n_polys = nullptr;
  const float* dest = nullptr;
  const float* starts = nullptr;
  const int32_t* n_starts = nullptr;
  const int32_t* levels = nullptr;

  // single async prefetch lane
  std::thread worker;
  std::atomic<bool> inflight{false};
  std::vector<float> pf_edges;
  std::vector<uint8_t> pf_mask;
  std::vector<int32_t> pf_poly;
  std::vector<int32_t> pf_npolys;
  std::vector<float> pf_dest;
  std::vector<float> pf_starts;
  std::vector<int32_t> pf_nstarts;
  std::vector<int32_t> pf_levels;
  int64_t pf_n = 0, pf_E = 0, pf_S = 0;
};

struct Out {
  float* edges;
  uint8_t* mask;
  int32_t* poly;
  int32_t* n_polys;
  float* dest;
  float* starts;
  int32_t* n_starts;
  int32_t* levels;
};

void gather_range(const Bank* b, const int64_t* ids, int64_t lo, int64_t hi,
                  int64_t oE, int64_t oS, const Out& o) {
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t c = ids[i] % b->C;
    // live edges are packed front-first per case, so truncation to the
    // runtime budget oE keeps every live edge up to the budget
    std::memcpy(o.edges + i * oE * 4, b->edges + c * b->E * 4,
                sizeof(float) * oE * 4);
    std::memcpy(o.mask + i * oE, b->edge_mask + c * b->E, oE);
    std::memcpy(o.poly + i * oE, b->edge_poly + c * b->E,
                sizeof(int32_t) * oE);
    o.n_polys[i] = b->n_polys[c];
    std::memcpy(o.dest + i * 3, b->dest + c * 3, sizeof(float) * 3);
    std::memcpy(o.starts + i * oS * 3, b->starts + c * b->S * 3,
                sizeof(float) * oS * 3);
    int32_t ns = b->n_starts[c];
    o.n_starts[i] = ns < oS ? ns : static_cast<int32_t>(oS);
    std::memcpy(o.levels + i * oS, b->levels + c * b->S, sizeof(int32_t) * oS);
  }
}

void gather(const Bank* b, const int64_t* ids, int64_t n, int64_t oE,
            int64_t oS, const Out& o, int nthreads) {
  if (nthreads <= 1 || n < 64) {
    gather_range(b, ids, 0, n, oE, oS, o);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(gather_range, b, ids, lo, hi, oE, oS, std::cref(o));
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

Bank* htpb_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const int64_t* hdr = static_cast<const int64_t*>(base);
  if (st.st_size < 32 || hdr[0] != kMagic) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Bank* b = new Bank();
  b->fd = fd;
  b->base = static_cast<const uint8_t*>(base);
  b->size = st.st_size;
  b->C = hdr[1];
  b->E = hdr[2];
  b->S = hdr[3];
  const uint8_t* p = b->base + 32;
  auto take = [&p](size_t bytes) {
    const uint8_t* q = p;
    p += bytes;
    return q;
  };
  b->edges = reinterpret_cast<const float*>(take(b->C * b->E * 4 * 4));
  b->edge_mask = take(b->C * b->E);
  b->edge_poly = reinterpret_cast<const int32_t*>(take(b->C * b->E * 4));
  b->n_polys = reinterpret_cast<const int32_t*>(take(b->C * 4));
  b->dest = reinterpret_cast<const float*>(take(b->C * 3 * 4));
  b->starts = reinterpret_cast<const float*>(take(b->C * b->S * 3 * 4));
  b->n_starts = reinterpret_cast<const int32_t*>(take(b->C * 4));
  b->levels = reinterpret_cast<const int32_t*>(take(b->C * b->S * 4));
  if (static_cast<size_t>(p - b->base) > b->size) {
    munmap(const_cast<uint8_t*>(b->base), b->size);
    ::close(b->fd);
    delete b;
    return nullptr;
  }
  return b;
}

void htpb_close(Bank* b) {
  if (!b) return;
  if (b->inflight.load() && b->worker.joinable()) b->worker.join();
  if (b->worker.joinable()) b->worker.join();
  munmap(const_cast<uint8_t*>(b->base), b->size);
  ::close(b->fd);
  delete b;
}

int64_t htpb_n_cases(const Bank* b) { return b->C; }
int64_t htpb_max_edges(const Bank* b) { return b->E; }
int64_t htpb_max_starts(const Bank* b) { return b->S; }

void htpb_gather(const Bank* b, const int64_t* ids, int64_t n,
                 int64_t out_E, int64_t out_S, float* edges, uint8_t* mask,
                 int32_t* poly, int32_t* n_polys, float* dest, float* starts,
                 int32_t* n_starts, int32_t* levels, int nthreads) {
  Out o{edges, mask, poly, n_polys, dest, starts, n_starts, levels};
  gather(b, ids, n, out_E, out_S, o, nthreads);
}

// ------------------------------------------------------ async prefetch lane

int htpb_prefetch(Bank* b, const int64_t* ids, int64_t n, int64_t out_E,
                  int64_t out_S, int nthreads) {
  if (b->inflight.load()) return -1;  // one in-flight prefetch per bank
  if (b->worker.joinable()) b->worker.join();
  b->pf_n = n;
  b->pf_E = out_E;
  b->pf_S = out_S;
  b->pf_edges.resize(n * out_E * 4);
  b->pf_mask.resize(n * out_E);
  b->pf_poly.resize(n * out_E);
  b->pf_npolys.resize(n);
  b->pf_dest.resize(n * 3);
  b->pf_starts.resize(n * out_S * 3);
  b->pf_nstarts.resize(n);
  b->pf_levels.resize(n * out_S);
  std::vector<int64_t> ids_copy(ids, ids + n);
  b->inflight.store(true);
  b->worker = std::thread([b, ids_copy = std::move(ids_copy), out_E, out_S,
                           nthreads]() {
    Out o{b->pf_edges.data(),   b->pf_mask.data(),   b->pf_poly.data(),
          b->pf_npolys.data(),  b->pf_dest.data(),   b->pf_starts.data(),
          b->pf_nstarts.data(), b->pf_levels.data()};
    gather(b, ids_copy.data(), static_cast<int64_t>(ids_copy.size()), out_E,
           out_S, o, nthreads);
    b->inflight.store(false);
  });
  return 0;
}

// blocks until the in-flight prefetch completes and copies into caller memory
int htpb_wait(Bank* b, float* edges, uint8_t* mask, int32_t* poly,
              int32_t* n_polys, float* dest, float* starts, int32_t* n_starts,
              int32_t* levels) {
  if (!b->worker.joinable()) return -1;
  b->worker.join();
  std::memcpy(edges, b->pf_edges.data(), b->pf_edges.size() * sizeof(float));
  std::memcpy(mask, b->pf_mask.data(), b->pf_mask.size());
  std::memcpy(poly, b->pf_poly.data(), b->pf_poly.size() * sizeof(int32_t));
  std::memcpy(n_polys, b->pf_npolys.data(),
              b->pf_npolys.size() * sizeof(int32_t));
  std::memcpy(dest, b->pf_dest.data(), b->pf_dest.size() * sizeof(float));
  std::memcpy(starts, b->pf_starts.data(),
              b->pf_starts.size() * sizeof(float));
  std::memcpy(n_starts, b->pf_nstarts.data(),
              b->pf_nstarts.size() * sizeof(int32_t));
  std::memcpy(levels, b->pf_levels.data(),
              b->pf_levels.size() * sizeof(int32_t));
  return 0;
}

}  // extern "C"
