// Native feature packer: the host data pipeline's hot path.
//
// The reference loads {vid}_resnet.npy + {vid}_bn.npy per example with
// numpy inside __getitem__ (reference: recursive_caption_dataset.py:187-189,
// :389-416): parse -> concat -> span-index -> linspace-downsample -> pad.
// This C++ implementation mmaps the .npy files (zero-copy), writes clip
// rows straight into the caller's fixed-shape (S, L, D) batch buffer, and
// parallelizes across clips with a small thread pool.  Exposed via a C ABI
// consumed through ctypes (svpc_torch/native/__init__.py), which builds it
// with g++ on first use into build/svpc_torch_native/; the numpy fill
// stays available only on request (use_native=False).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#endif

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyArray {
  void* map_base = nullptr;
  size_t map_len = 0;
  const void* data = nullptr;  // '<f4' or '<f2', C-order
  int64_t rows = 0;
  int64_t cols = 0;
  bool is_half = false;
  bool ok = false;
};

// Exact widening conversion, matching numpy's float16 -> float32 cast
// (including subnormals, infinities and NaN payloads).
inline float half_to_float(uint16_t h) {
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  const uint32_t exp = (h >> 10) & 0x1fu;
  uint32_t man = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // +-0
    } else {
      int p = 9;  // normalize the subnormal: v = 2^-14 * man/2^10
      while (!(man & (1u << p))) --p;
      const uint32_t rest = man & ((1u << p) - 1u);
      bits = sign | (static_cast<uint32_t>(103 + p) << 23)
          | (rest << (23 - p));
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000u | (man << 13);  // inf / NaN
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

void half_cvt_scalar(const uint16_t* src, float* dst, int64_t n) {
  for (int64_t c = 0; c < n; ++c) dst[c] = half_to_float(src[c]);
}

#if defined(__x86_64__) && defined(__GNUC__)
__attribute__((target("f16c,avx")))
void half_cvt_f16c(const uint16_t* src, float* dst, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    _mm256_storeu_ps(dst + i, _mm256_cvtph_ps(_mm_loadu_si128(
        reinterpret_cast<const __m128i*>(src + i))));
  }
  for (; i < n; ++i) dst[i] = half_to_float(src[i]);
}
#endif

using HalfCvtFn = void (*)(const uint16_t*, float*, int64_t);

HalfCvtFn resolve_half_cvt() {
#if defined(__x86_64__) && defined(__GNUC__)
  if (__builtin_cpu_supports("f16c") && __builtin_cpu_supports("avx"))
    return half_cvt_f16c;  // hardware widening (bit-identical to scalar)
#endif
  return half_cvt_scalar;
}

const HalfCvtFn g_half_cvt = resolve_half_cvt();

// One feature row into the f32 batch buffer: memcpy for f4 sources, the
// exact widening conversion for f2 (half-precision feature stores halve
// disk + memory traffic; see cli/convert_features.py).
inline void copy_row(float* dst, const NpyArray& a, int64_t row) {
  if (!a.is_half) {
    std::memcpy(dst, static_cast<const float*>(a.data) + row * a.cols,
                a.cols * sizeof(float));
  } else {
    g_half_cvt(static_cast<const uint16_t*>(a.data) + row * a.cols,
               dst, a.cols);
  }
}

// Minimal .npy (v1.x/2.x) header parser for '<f4'/'<f2', C-order, 2-D
// arrays.
NpyArray open_npy(const char* path) {
  NpyArray out;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return out;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) { ::close(fd); return out; }
  // MAP_POPULATE (Linux-only) prefaults the mapping in one sequential
  // sweep: per-access soft faults otherwise dominate the copy (~2 ms/video
  // of ~1 us faults vs memcpy at 8 GB/s) since every video is a fresh
  // mapping
#ifdef MAP_POPULATE
  constexpr int kMapFlags = MAP_PRIVATE | MAP_POPULATE;
#else
  constexpr int kMapFlags = MAP_PRIVATE;
#endif
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, kMapFlags, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return out;
  const unsigned char* p = static_cast<const unsigned char*>(base);
  if (memcmp(p, "\x93NUMPY", 6) != 0) { ::munmap(base, st.st_size); return out; }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (p[10] << 16)
        | (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  }
  if (header_off + header_len > static_cast<size_t>(st.st_size)) {
    // corrupt header-length field: constructing the header string (or
    // reading data at the claimed offset) would run past the mapping
    ::munmap(base, st.st_size);
    return out;
  }
  std::string header(reinterpret_cast<const char*>(p + header_off), header_len);
  const bool is_f4 = header.find("'<f4'") != std::string::npos;
  const bool is_f2 = header.find("'<f2'") != std::string::npos;
  if ((!is_f4 && !is_f2) ||
      header.find("'fortran_order': False") == std::string::npos) {
    ::munmap(base, st.st_size);
    return out;
  }
  out.is_half = is_f2;
  size_t sh = header.find("'shape': (");
  if (sh == std::string::npos) { ::munmap(base, st.st_size); return out; }
  sh += 10;
  out.rows = std::strtoll(header.c_str() + sh, nullptr, 10);
  size_t comma = header.find(',', sh);
  out.cols = std::strtoll(header.c_str() + comma + 1, nullptr, 10);
  if (out.rows <= 0 || out.cols <= 0) { ::munmap(base, st.st_size); return out; }
  const size_t itemsize = is_f2 ? 2 : 4;
  const size_t need = static_cast<size_t>(out.rows)
      * static_cast<size_t>(out.cols) * itemsize;
  if (static_cast<size_t>(st.st_size) - header_off - header_len < need) {
    // truncated file (e.g. an interrupted convert_features run): reading
    // late rows would SIGBUS past the mapping — fail cleanly instead,
    // like np.load's ValueError on the same file
    ::munmap(base, st.st_size);
    return out;
  }
  out.map_base = base;
  out.map_len = st.st_size;
  out.data = p + header_off + header_len;
  out.ok = true;
  return out;
}

void close_npy(NpyArray& a) {
  if (a.map_base) ::munmap(a.map_base, a.map_len);
  a.map_base = nullptr;
}

// Persistent mmap cache: feature files are an immutable store read every
// epoch, and a fresh mmap pays ~1 us/page of soft faults on every access
// (~2 ms per video — more than the memcpy itself).  Keeping the mapping
// alive makes epoch 2+ a pure page-cache memcpy.  Address space is cheap
// (the YC2 feature set is ~10 GB); svpc_mmap_cache_clear() drops it.
std::mutex g_cache_mu;
std::unordered_map<std::string, NpyArray> g_cache;
std::atomic<bool> g_cache_enabled{true};
// clear() in progress: acquire_npy must not hand out (or insert) cached
// mappings while set, independent of g_cache_enabled — so a concurrent
// svpc_mmap_cache_enable(1) cannot defeat the drain
std::atomic<bool> g_clear_pending{false};
// outstanding *cached* references (incremented under g_cache_mu at
// hand-out); clear() waits for this to drain so it never munmaps under
// an active memcpy.  Owned (non-cached) mappings don't count, so
// continuous packing cannot livelock the drain.
std::atomic<int64_t> g_cached_refs{0};

bool cache_usable() {
  return g_cache_enabled.load() && !g_clear_pending.load();
}

// (array, owned_by_caller) — caller close()s only when owned; a cached
// (non-owned) return holds one g_cached_refs reference the caller must
// release.
std::pair<NpyArray, bool> acquire_npy(const char* path) {
  if (!cache_usable()) return {open_npy(path), true};
  {
    std::lock_guard<std::mutex> lk(g_cache_mu);
    if (cache_usable()) {
      auto it = g_cache.find(path);
      if (it != g_cache.end()) {
        g_cached_refs.fetch_add(1);
        return {it->second, false};
      }
    }
  }
  NpyArray a = open_npy(path);
  if (!a.ok) return {a, true};
  std::lock_guard<std::mutex> lk(g_cache_mu);
  if (!cache_usable()) return {a, true};  // clear started meanwhile
  auto ins = g_cache.emplace(path, a);
  if (!ins.second) {  // lost a race; keep the incumbent mapping
    close_npy(a);
    g_cached_refs.fetch_add(1);
    return {ins.first->second, false};
  }
  g_cached_refs.fetch_add(1);
  return {a, false};
}

void release_npy(NpyArray& a, bool owned) {
  if (owned) {
    close_npy(a);
  } else {
    g_cached_refs.fetch_sub(1);
  }
}

// timestamp -> inclusive feature span (recursive_caption_dataset.py:379-387)
inline void span_from_timestamp(double st_sec, double ed_sec, double frm2sec,
                                int64_t feat_len, int64_t* st, int64_t* ed) {
  *st = static_cast<int64_t>(std::floor(st_sec / frm2sec));
  *ed = static_cast<int64_t>(std::ceil(ed_sec / frm2sec));
  *ed = std::min(*ed, feat_len - 1);
  // >=0 clamps mirror data/anet.py: the reference's min(st, ed-1) quirk
  // makes st = -1 when ed == 0 (a [0, 0] serving timestamp or a 1-row
  // feature file) — row -1 would be an out-of-bounds read here.
  // Annotated splits never produce ed <= 0, so this is parity-neutral.
  *ed = std::max<int64_t>(*ed, 0);
  *st = std::max<int64_t>(std::min(*st, *ed - 1), 0);
}

}  // namespace

extern "C" {

// Pack every clip of one video into the fixed-shape feature buffer.
//
//   out        : (n_clips, total_len, d_resnet + d_bn) f32, zero-initialized
//                by caller; row 0 ([CLS]) and the [SEP]/pad rows stay zero.
//   valid_lens : (n_clips,) int64 — number of [VID] rows written per clip.
//
// Returns 0 on success, negative error code otherwise.
//   expected_d : the caller's buffer row width — the files' summed cols
//                must equal it exactly (error -4), or a wrong-dimension
//                feature file would stride writes past the buffer.
int svpc_pack_video(const char* resnet_path, const char* bn_path,
                    const double* timestamps,  // (n_clips, 2)
                    int64_t n_clips, double frm2sec, int64_t max_v_len,
                    int64_t total_len, int64_t expected_d, float* out,
                    int64_t* valid_lens, int64_t n_threads) {
  auto [resnet, own_r] = acquire_npy(resnet_path);
  auto [bn, own_b] = acquire_npy(bn_path);
  auto release = [&]() {
    release_npy(resnet, own_r);
    release_npy(bn, own_b);
  };
  if (!resnet.ok || !bn.ok) {
    release();
    return -1;
  }
  if (resnet.rows != bn.rows) {
    release();
    return -2;
  }
  if (resnet.cols + bn.cols != expected_d) {
    release();
    return -4;
  }
  const int64_t feat_len = resnet.rows;
  const int64_t d_r = resnet.cols, d_b = bn.cols, d = d_r + d_b;
  const int64_t max_v_l = max_v_len - 2;

  // Hard in-library bound: a clip's token span (CLS + rows + SEP) must
  // fit the buffer's row budget even if the caller's valid-length
  // bookkeeping went stale (e.g. a feature file replaced on disk after
  // lengths were computed) — never write past a clip slot.
  std::atomic<bool> overflow{false};

  auto pack_clip = [&](int64_t c) {
    int64_t st, ed;
    span_from_timestamp(timestamps[2 * c], timestamps[2 * c + 1], frm2sec,
                        feat_len, &st, &ed);
    const int64_t span = ed - st + 1;
    if (std::min(span, max_v_l) + 2 > total_len) {
      overflow.store(true);
      return;
    }
    float* clip_out = out + c * total_len * d;
    if (span > max_v_l) {
      // np.linspace(st, ed, max_v_l, endpoint=True).astype(int64)
      const double step = static_cast<double>(ed - st) / (max_v_l - 1);
      for (int64_t i = 0; i < max_v_l; ++i) {
        int64_t src = static_cast<int64_t>(st + step * i);
        if (i == max_v_l - 1) src = ed;
        float* dst = clip_out + (i + 1) * d;
        copy_row(dst, resnet, src);
        copy_row(dst + d_r, bn, src);
      }
      valid_lens[c] = max_v_l;
    } else {
      for (int64_t i = 0; i < span; ++i) {
        const int64_t src = st + i;
        float* dst = clip_out + (i + 1) * d;
        copy_row(dst, resnet, src);
        copy_row(dst + d_r, bn, src);
      }
      valid_lens[c] = span;
    }
  };

  if (n_threads <= 1 || n_clips <= 1) {
    for (int64_t c = 0; c < n_clips; ++c) pack_clip(c);
  } else {
    std::vector<std::thread> workers;
    const int64_t n_w = std::min<int64_t>(n_threads, n_clips);
    for (int64_t w = 0; w < n_w; ++w) {
      workers.emplace_back([&, w]() {
        for (int64_t c = w; c < n_clips; c += n_w) pack_clip(c);
      });
    }
    for (auto& t : workers) t.join();
  }

  release();
  return overflow.load() ? -3 : 0;
}

// Drop every cached mapping (tests / memory pressure / replaced files).
// Sets the clear-pending flag (which blocks new cached hand-outs even if
// svpc_mmap_cache_enable(1) races in), waits for outstanding cached
// references to drain — owned mappings don't block the drain — then
// unmaps.  Safe to call concurrently with itself.
void svpc_mmap_cache_clear() {
  g_clear_pending.store(true);
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(g_cache_mu);
      if (g_cached_refs.load() == 0) {
        for (auto& kv : g_cache) close_npy(kv.second);
        g_cache.clear();
        break;
      }
    }
    // wait for outstanding copies with the lock released
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  g_clear_pending.store(false);
}

// Toggle the mmap cache (on by default).
void svpc_mmap_cache_enable(int on) {
  g_cache_enabled.store(on != 0);
}

// Probe a video's feature length without loading data (for fix_missing /
// sanity checks).  Returns rows, or -1 if unreadable.  Header-only pread
// — open_npy's MAP_POPULATE would prefault the whole file (GBs of IO)
// just to read a ~100-byte header.
int64_t svpc_npy_rows(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  unsigned char pre[12];
  if (::pread(fd, pre, 12, 0) != 12 || memcmp(pre, "\x93NUMPY", 6) != 0) {
    ::close(fd);
    return -1;
  }
  size_t header_len, header_off;
  if (pre[6] == 1) {
    header_len = pre[8] | (pre[9] << 8);
    header_off = 10;
  } else {
    header_len = pre[8] | (pre[9] << 8) | (pre[10] << 16)
        | (static_cast<size_t>(pre[11]) << 24);
    header_off = 12;
  }
  if (header_len == 0 || header_len > (1u << 20)) { ::close(fd); return -1; }
  std::string header(header_len, '\0');
  const ssize_t got = ::pread(fd, header.data(), header_len, header_off);
  ::close(fd);
  if (got != static_cast<ssize_t>(header_len)) return -1;
  size_t sh = header.find("'shape': (");
  if (sh == std::string::npos) return -1;
  const int64_t rows = std::strtoll(header.c_str() + sh + 10, nullptr, 10);
  return rows > 0 ? rows : -1;
}

}  // extern "C"
