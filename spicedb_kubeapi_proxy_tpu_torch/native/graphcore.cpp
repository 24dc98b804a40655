// Host-side graph-builder core for the PyTorch engine (bulk load and
// graph compile; no device code lives here).
//
// A copy of the JAX package's native/graphcore.cpp, cut to the three entry
// points the port uses. Three operations dominate snapshot refresh at the
// 10M-relationship scale:
//
//   1. bulk string interning (unique + inverse over id columns)
//   2. the stable sort of edges by destination slot
//   3. the store's row-key index (hash + radix sort)
//
// All are pure functions over flat buffers so the Python side (ctypes, see
// __init__.py) keeps ownership of all state and falls back to numpy when the
// library is unavailable.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread graphcore.cpp -o <out>.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// FNV-1a over a fixed-width field (NUL padding participates on both sides of
// any comparison, so padded equality is exact equality).
static inline uint64_t hash_bytes(const char* p, int64_t len) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(p[i]);
    h *= 1099511628211ull;
  }
  return h;
}

struct Slot {
  int64_t row;   // first-occurrence row index, -1 = empty
  uint64_t hash;
};

}  // namespace

extern "C" {

// Hash-based unique+inverse over a fixed-width string column (numpy 'S'
// layout: n rows of `width` bytes). Writes the inverse (id per row, dense in
// first-occurrence order) to inv_out[n] and first-occurrence row indices to
// uniq_rows_out (capacity n). Returns the unique count.
int64_t unique_inverse_fixed(const char* data, int64_t width, int64_t n,
                             int32_t* inv_out, int64_t* uniq_rows_out) {
  if (n <= 0) return 0;
  // open addressing, power-of-two capacity >= 2n
  uint64_t cap = 16;
  while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
  std::vector<Slot> table(cap, Slot{-1, 0});
  const uint64_t mask = cap - 1;
  int64_t n_uniq = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* s = data + i * width;
    const uint64_t h = hash_bytes(s, width);
    uint64_t j = h & mask;
    for (;;) {
      Slot& slot = table[j];
      if (slot.row < 0) {
        slot.row = i;
        slot.hash = h;
        uniq_rows_out[n_uniq] = i;
        inv_out[i] = static_cast<int32_t>(n_uniq);
        ++n_uniq;
        break;
      }
      if (slot.hash == h &&
          std::memcmp(data + slot.row * width, s, width) == 0) {
        inv_out[i] = inv_out[slot.row];
        break;
      }
      j = (j + 1) & mask;
    }
  }
  return n_uniq;
}

// Stable ascending sort permutation of non-negative int64 keys (LSD radix,
// 16-bit digits). out_perm[n] receives row indices; equal keys keep input
// order — compile_graph relies on this to keep residual edges dst-sorted.
void sort_perm_i64(const int64_t* keys, int64_t n, int64_t* out_perm) {
  if (n <= 0) return;
  int64_t max_key = 0;
  for (int64_t i = 0; i < n; ++i) {
    out_perm[i] = i;
    if (keys[i] > max_key) max_key = keys[i];
  }
  std::vector<int64_t> tmp(n);
  int64_t* src = out_perm;
  int64_t* dst = tmp.data();
  for (int shift = 0; shift < 64 && (max_key >> shift) != 0; shift += 16) {
    int64_t counts[65536] = {0};
    for (int64_t i = 0; i < n; ++i)
      ++counts[(keys[src[i]] >> shift) & 0xffff];
    int64_t total = 0;
    for (int b = 0; b < 65536; ++b) {
      int64_t c = counts[b];
      counts[b] = total;
      total += c;
    }
    for (int64_t i = 0; i < n; ++i)
      dst[counts[(keys[src[i]] >> shift) & 0xffff]++] = src[i];
    std::swap(src, dst);
  }
  if (src != out_perm) std::memcpy(out_perm, src, n * sizeof(int64_t));
}

}  // extern "C"

// Row-key index build for the relationship store (engine/store.py
// StoreIndex): mix the six int32 key columns into 64-bit hashes — the
// arithmetic MUST match _hash_key_cols in store.py, which hashes single
// lookup keys against this output — then produce the ascending-hash
// permutation with a multithreaded LSD radix sort. Stability is
// irrelevant (collisions are verified against the columns at lookup), but
// LSD radix is stable anyway.
namespace {

static inline uint64_t mix_key(int32_t rt, int32_t rid, int32_t rl,
                               int32_t st, int32_t sid, int32_t srl) {
  const uint64_t M1 = 0x9E3779B97F4A7C15ull;
  const uint64_t M2 = 0xBF58476D1CE4E5B9ull;
  uint64_t h = static_cast<uint64_t>(rt);
  const int32_t cs[5] = {rid, rl, st, sid, srl};
  for (int i = 0; i < 5; ++i) {
    h = (h ^ static_cast<uint64_t>(cs[i])) * M1;
    h ^= h >> 29;
  }
  h *= M2;
  return h ^ (h >> 32);
}

static inline int pick_threads(int64_t n) {
  if (n < (1 << 20)) return 1;
  unsigned hw = std::thread::hardware_concurrency();
  int t = hw ? static_cast<int>(hw) : 4;
  return t > 16 ? 16 : t;
}

template <typename F>
static void parallel_ranges(int64_t n, int nt, F f) {
  if (nt <= 1) {
    f(0, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t step = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = t * step;
    const int64_t hi = lo + step < n ? lo + step : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { f(t, lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" void index_build_u64(
    const int32_t* rt, const int32_t* rid, const int32_t* rl,
    const int32_t* st, const int32_t* sid, const int32_t* srl, int64_t n,
    uint64_t* hashes_out, int64_t* order_out) {
  if (n <= 0) return;
  const int nt = pick_threads(n);
  std::vector<uint64_t> keys_a(n), keys_b(n);
  std::vector<int64_t> perm_b(n);
  parallel_ranges(n, nt, [&](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      keys_a[i] = mix_key(rt[i], rid[i], rl[i], st[i], sid[i], srl[i]);
      order_out[i] = i;
    }
  });
  uint64_t* ksrc = keys_a.data();
  uint64_t* kdst = keys_b.data();
  int64_t* psrc = order_out;
  int64_t* pdst = perm_b.data();
  // 4 passes of 16-bit digits over the full 64-bit hash
  for (int shift = 0; shift < 64; shift += 16) {
    std::vector<std::vector<int64_t>> counts(
        nt, std::vector<int64_t>(65536, 0));
    parallel_ranges(n, nt, [&](int t, int64_t lo, int64_t hi) {
      auto& c = counts[t];
      for (int64_t i = lo; i < hi; ++i)
        ++c[(ksrc[i] >> shift) & 0xffff];
    });
    // digit-major exclusive prefix across (digit, thread): keeps each
    // thread's scatter region contiguous per digit (stable)
    int64_t running = 0;
    for (int b = 0; b < 65536; ++b) {
      for (int t = 0; t < nt; ++t) {
        const int64_t c = counts[t][b];
        counts[t][b] = running;
        running += c;
      }
    }
    parallel_ranges(n, nt, [&](int t, int64_t lo, int64_t hi) {
      auto& pos = counts[t];
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t j = pos[(ksrc[i] >> shift) & 0xffff]++;
        kdst[j] = ksrc[i];
        pdst[j] = psrc[i];
      }
    });
    std::swap(ksrc, kdst);
    std::swap(psrc, pdst);
  }
  // 4 passes = even number of swaps: results are back in keys_a/order_out
  std::memcpy(hashes_out, ksrc, n * sizeof(uint64_t));
  if (psrc != order_out)
    std::memcpy(order_out, psrc, n * sizeof(int64_t));
}

extern "C" int64_t graphcore_abi_version() { return 1; }
