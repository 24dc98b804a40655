// Host-side graph-builder core for the PyTorch engine (bulk load and
// graph compile; no device code lives here).
//
// A copy of the JAX package's native/graphcore.cpp: the store and compile
// helpers, and the proxy's list-body scanners (json_list_spans,
// proto_list_spans, proto_table_spans; authz/filterer.py). Three
// operations dominate snapshot refresh at the 10M-relationship scale:
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

// Bumped on ANY exported-signature change: the loader refuses a library
// whose ABI differs.
extern "C" int64_t graphcore_abi_version() { return 2; }

// ---------------------------------------------------------------------------
// JSON list scanner (authz/filterer.py): one pass over a kube List response
// body locating the top-level "kind" value, the top-level `items_key` array,
// every element's byte span, and each element's metadata.name /
// metadata.namespace string-value spans (raw bytes between the quotes —
// escape decoding, when needed, happens Python-side). Lets the filter keep
// items BYTE-IDENTICAL and skip json.loads on multi-MB bodies.
//
// Returns the item count (>= 0) on success, or a negative bail code — the
// caller then falls back to the Python json path, so this scanner is
// conservative: anything structurally surprising (escaped keys,
// non-object items, duplicate items keys, trailing garbage, malformed
// strings or scalar tokens anywhere) bails rather than risking
// semantics that differ from json.loads. Known disclosed laxity: the
// comma/colon PLACEMENT inside skipped substructure is not re-validated
// — a body like {"spec":{"a" "b"}} passes here where json.loads raises
// (which the Python path turns into a 401); an apiserver never emits
// such bodies, and no AUTHORIZATION decision depends on skipped bytes.

namespace jsonscan {

struct Scan {
  const char* b;
  int64_t n;
  int64_t i = 0;
  bool fail = false;

  void ws() {
    while (i < n) {
      const char c = b[i];
      if (c == ' ' || c == '\t' || c == '\n' || c == '\r') ++i;
      else break;
    }
  }
  bool at(char c) { return i < n && b[i] == c; }
  static bool hex(unsigned char c) {
    return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'f') ||
           (c >= 'A' && c <= 'F');
  }
  // raw string content span [s, e); has_esc set when a backslash occurs.
  // Validates exactly what json.loads does at the string level: literal
  // control bytes (< 0x20) fail (strict mode — which also guarantees
  // raw spans never contain the 0x1f/0x1e record separators of the key
  // buffer), escape sequences must be well-formed, and the bytes must
  // be valid UTF-8 (no overlongs, no surrogates, <= U+10FFFF) so raw
  // byte comparison is equivalent to decoded string comparison.
  bool str_span(int64_t* s, int64_t* e, bool* has_esc) {
    if (!at('"')) { fail = true; return false; }
    ++i;
    *s = i;
    *has_esc = false;
    while (i < n) {
      const unsigned char c = b[i];
      if (c < 0x20) { fail = true; return false; }
      if (c == '\\') {
        *has_esc = true;
        if (i + 1 >= n) { fail = true; return false; }
        const unsigned char esc = b[i + 1];
        if (esc == 'u') {
          if (i + 5 >= n || !hex(b[i + 2]) || !hex(b[i + 3]) ||
              !hex(b[i + 4]) || !hex(b[i + 5])) {
            fail = true;
            return false;
          }
          i += 6;
        } else if (esc == '"' || esc == '\\' || esc == '/' ||
                   esc == 'b' || esc == 'f' || esc == 'n' ||
                   esc == 'r' || esc == 't') {
          i += 2;
        } else {
          fail = true;  // invalid escape: json.loads rejects
          return false;
        }
        continue;
      }
      if (c == '"') { *e = i; ++i; return true; }
      if (c < 0x80) { ++i; continue; }
      // multi-byte UTF-8, validated like CPython's decoder
      int need;
      unsigned char lo = 0x80, hi = 0xBF;
      if (c >= 0xC2 && c <= 0xDF) need = 1;
      else if (c == 0xE0) { need = 2; lo = 0xA0; }
      else if (c >= 0xE1 && c <= 0xEC) need = 2;
      else if (c == 0xED) { need = 2; hi = 0x9F; }  // no surrogates
      else if (c == 0xEE || c == 0xEF) need = 2;
      else if (c == 0xF0) { need = 3; lo = 0x90; }
      else if (c >= 0xF1 && c <= 0xF3) need = 3;
      else if (c == 0xF4) { need = 3; hi = 0x8F; }  // <= U+10FFFF
      else { fail = true; return false; }
      if (i + need >= n) { fail = true; return false; }
      unsigned char c1 = b[i + 1];
      if (c1 < lo || c1 > hi) { fail = true; return false; }
      for (int k = 2; k <= need; ++k) {
        const unsigned char ck = b[i + k];
        if (ck < 0x80 || ck > 0xBF) { fail = true; return false; }
      }
      i += need + 1;
    }
    fail = true;
    return false;
  }
  bool key_is(int64_t s, int64_t e, const char* lit) {
    const int64_t m = (int64_t)strlen(lit);
    return e - s == m && memcmp(b + s, lit, (size_t)m) == 0;
  }
  // strict scalar token: number / true / false / null / NaN / ±Infinity
  // — the exact forms json.loads accepts, number grammar included
  // (leading zeros, '+' signs, dangling exponents all fail)
  void scalar() {
    const int64_t s = i;
    while (i < n) {
      const char c = b[i];
      if (c == ',' || c == '}' || c == ']' || c == ':' || c == ' ' ||
          c == '\t' || c == '\n' || c == '\r')
        break;
      ++i;
    }
    const int64_t m = i - s;
    if (m <= 0) { fail = true; return; }
    auto is = [&](const char* lit) {
      return (int64_t)strlen(lit) == m && memcmp(b + s, lit, (size_t)m) == 0;
    };
    if (is("true") || is("false") || is("null") || is("NaN") ||
        is("Infinity") || is("-Infinity"))
      return;
    // -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?
    const char* p = b + s;
    int64_t k = 0;
    auto dig = [&](int64_t j) {
      return j < m && p[j] >= '0' && p[j] <= '9';
    };
    if (k < m && p[k] == '-') ++k;
    if (!dig(k)) { fail = true; return; }
    if (p[k] == '0') ++k;
    else while (dig(k)) ++k;
    if (k < m && p[k] == '.') {
      ++k;
      if (!dig(k)) { fail = true; return; }
      while (dig(k)) ++k;
    }
    if (k < m && (p[k] == 'e' || p[k] == 'E')) {
      ++k;
      if (k < m && (p[k] == '+' || p[k] == '-')) ++k;
      if (!dig(k)) { fail = true; return; }
      while (dig(k)) ++k;
    }
    if (k != m) fail = true;
  }
  // Skip any value. Containers are walked iteratively with every string
  // and scalar TOKEN validated (so `@@@` or `1e+e+5` anywhere bails);
  // comma/colon PLACEMENT inside skipped substructure is not re-checked
  // — that is the one laxity vs json.loads, disclosed in the entry
  // point's contract comment.
  void skip_value() {
    ws();
    if (fail || i >= n) { fail = true; return; }
    const char c0 = b[i];
    if (c0 == '"') {
      int64_t s, e;
      bool esc;
      str_span(&s, &e, &esc);
      return;
    }
    if (c0 == '{' || c0 == '[') {
      int64_t depth = 0;
      while (i < n) {
        const char c = b[i];
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
            c == ',' || c == ':') {
          ++i;
          continue;
        }
        if (c == '"') {
          int64_t s, e;
          bool esc;
          if (!str_span(&s, &e, &esc)) return;
          continue;
        }
        if (c == '{' || c == '[') { ++depth; ++i; continue; }
        if (c == '}' || c == ']') {
          --depth;
          ++i;
          if (depth == 0) return;
          if (depth < 0) { fail = true; return; }
          continue;
        }
        scalar();
        if (fail) return;
      }
      fail = true;
      return;
    }
    scalar();
  }
};

}  // namespace jsonscan

extern "C" int64_t json_list_spans(
    const char* buf, int64_t n, const char* items_key,
    int64_t* kind_span,   // [2] raw value span, -1,-1 when absent
    int64_t* arr_span,    // [2] start = after '[', end = index of ']'
    int64_t* item_spans,  // [2 * max_items]
    char* key_buf,        // >= n + 3*max_items bytes; per item one record
                          // [esc '0'|'1'] ns_raw 0x1f name_raw 0x1e (raw =
                          // undecoded string content; missing -> empty)
    int64_t* key_len,     // out: bytes written into key_buf
    int64_t nested,       // 0: metadata at item top level (List items);
                          // 1: inside item["object"] (Table rows)
    int64_t max_items) {
  jsonscan::Scan sc{buf, n};
  kind_span[0] = kind_span[1] = -1;
  arr_span[0] = arr_span[1] = -1;
  *key_len = 0;
  int64_t count = 0;
  bool items_seen = false;
  // per-item metadata string spans (last-wins under duplicate keys, so
  // the record is emitted only when the item closes)
  int64_t nm_s, nm_e, ns_s, ns_e;
  bool nm_esc, ns_esc;

  // one object level: dispatch(key_s, key_e) -> true when it consumed the
  // value itself; false means "skip it here"
  auto walk_object = [&](auto&& on_key) -> bool {
    sc.ws();
    if (!sc.at('{')) { sc.fail = true; return false; }
    ++sc.i;
    sc.ws();
    if (sc.at('}')) { ++sc.i; return true; }
    while (true) {
      sc.ws();
      int64_t ks, ke;
      bool kesc;
      if (!sc.str_span(&ks, &ke, &kesc)) return false;
      if (kesc) { sc.fail = true; return false; }  // escaped key: bail
      sc.ws();
      if (!sc.at(':')) { sc.fail = true; return false; }
      ++sc.i;
      if (!on_key(ks, ke)) sc.skip_value();
      if (sc.fail) return false;
      sc.ws();
      if (sc.at(',')) { ++sc.i; continue; }
      if (sc.at('}')) { ++sc.i; return true; }
      sc.fail = true;
      return false;
    }
  };

  auto parse_metadata = [&]() -> bool {
    // last-wins like dict construction: reset, then fill
    nm_s = nm_e = ns_s = ns_e = -1;
    nm_esc = ns_esc = false;
    sc.ws();
    if (!sc.at('{')) { sc.fail = true; return false; }
    return walk_object([&](int64_t ks, int64_t ke) -> bool {
      const bool is_name = sc.key_is(ks, ke, "name");
      const bool is_ns = !is_name && sc.key_is(ks, ke, "namespace");
      if (!is_name && !is_ns) return false;
      sc.ws();
      if (!sc.at('"')) {
        // non-string name/namespace: Python's or-coercion semantics
        // differ from treat-as-missing — bail to the json path
        sc.fail = true;
        return true;
      }
      int64_t vs, ve;
      bool vesc;
      if (!sc.str_span(&vs, &ve, &vesc)) return true;
      if (is_name) { nm_s = vs; nm_e = ve; nm_esc = vesc; }
      else { ns_s = vs; ns_e = ve; ns_esc = vesc; }
      return true;
    });
  };

  auto parse_item = [&]() -> bool {
    if (count >= max_items) { sc.fail = true; return false; }
    const int64_t idx = count;
    nm_s = nm_e = ns_s = ns_e = -1;
    nm_esc = ns_esc = false;
    sc.ws();
    const int64_t start = sc.i;
    if (!sc.at('{')) { sc.fail = true; return false; }  // non-object item
    const bool walked =
        nested
            ? walk_object([&](int64_t ks, int64_t ke) -> bool {
                // Table row: the keyable object rides row["object"]
                // (reference filters rows by that object's metadata)
                if (!sc.key_is(ks, ke, "object")) return false;
                sc.ws();
                if (!sc.at('{')) { sc.fail = true; return true; }
                // last-wins under duplicate "object" keys: a later
                // object without metadata must CLEAR earlier spans
                nm_s = nm_e = ns_s = ns_e = -1;
                nm_esc = ns_esc = false;
                return walk_object([&](int64_t ks2, int64_t ke2) -> bool {
                  if (!sc.key_is(ks2, ke2, "metadata")) return false;
                  return parse_metadata();
                });
              })
            : walk_object([&](int64_t ks, int64_t ke) -> bool {
                if (!sc.key_is(ks, ke, "metadata")) return false;
                return parse_metadata();
              });
    if (!walked) return false;
    item_spans[2 * idx] = start;
    item_spans[2 * idx + 1] = sc.i;  // exclusive, after the closing '}'
    char* kb = key_buf + *key_len;
    *kb++ = (nm_esc || ns_esc) ? '1' : '0';
    if (ns_s >= 0) {
      memcpy(kb, buf + ns_s, (size_t)(ns_e - ns_s));
      kb += ns_e - ns_s;
    }
    *kb++ = '\x1f';
    if (nm_s >= 0) {
      memcpy(kb, buf + nm_s, (size_t)(nm_e - nm_s));
      kb += nm_e - nm_s;
    }
    *kb++ = '\x1e';
    *key_len = kb - key_buf;
    ++count;
    return true;
  };

  auto parse_items_array = [&]() -> bool {
    sc.ws();
    if (!sc.at('[')) { sc.fail = true; return false; }
    ++sc.i;
    arr_span[0] = sc.i;
    sc.ws();
    if (sc.at(']')) { arr_span[1] = sc.i; ++sc.i; return true; }
    while (true) {
      if (!parse_item()) return false;
      sc.ws();
      if (sc.at(',')) { ++sc.i; continue; }
      if (sc.at(']')) { arr_span[1] = sc.i; ++sc.i; return true; }
      sc.fail = true;
      return false;
    }
  };

  const bool ok = walk_object([&](int64_t ks, int64_t ke) -> bool {
    if (sc.key_is(ks, ke, "kind")) {
      sc.ws();
      if (!sc.at('"')) return false;  // non-string kind: skip
      int64_t vs, ve;
      bool vesc;
      if (!sc.str_span(&vs, &ve, &vesc)) return true;
      if (vesc) { sc.fail = true; return true; }  // escaped kind: bail
      // last-wins duplicate kind, like dict construction
      kind_span[0] = vs;
      kind_span[1] = ve;
      return true;
    }
    if (sc.key_is(ks, ke, items_key)) {
      if (items_seen) { sc.fail = true; return true; }  // dup items: bail
      items_seen = true;
      parse_items_array();
      return true;
    }
    return false;
  });
  if (!ok || sc.fail) return -1;
  sc.ws();
  if (sc.i != n) return -1;  // trailing garbage: json.loads would raise
  // items_key absent entirely: legal (count 0, arr_span -1) — the
  // caller may only need the kind (e.g. to rescan a Table under "rows")
  return count;
}

// ---------------------------------------------------------------------------
// Protobuf list scanner (authz/filterer.py filter_body_proto): one pass
// over a kube *List message's bytes (the runtime.Unknown `raw` field,
// magic stripped) locating every repeated `items` element's full chunk
// span (tag included) and packing the same per-item key records the JSON
// scanner emits: '0' ns 0x1f name 0x1e. First-occurrence field semantics
// mirror the Python walker (kubeproto._field). Bails (-1) on truncated
// wire data, or on names/namespaces containing control bytes (< 0x20 —
// would collide with the record separators) or invalid UTF-8 (the Python
// path decodes with errors="replace"; such names cannot legitimately
// exist in kube and authority stays with the slow path).

namespace protoscan {

struct PScan {
  const unsigned char* b;
  int64_t n;
  int64_t i = 0;
  bool fail = false;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (i < n) {
      const unsigned char c = b[i++];
      v |= (uint64_t)(c & 0x7F) << shift;
      if (!(c & 0x80)) return v;
      shift += 7;
      if (shift > 63) { fail = true; return 0; }
    }
    fail = true;
    return 0;
  }
  // skip one field of wire type wt (tag already consumed)
  void skip(int wt) {
    switch (wt) {
      case 0: varint(); return;
      case 1: i += 8; if (i > n) fail = true; return;
      case 2: {
        const uint64_t len = varint();
        if (fail) return;
        // validate BEFORE the signed cast: a huge length varint would
        // otherwise wrap negative and walk backward / spin forever
        if (len > (uint64_t)(n - i)) { fail = true; return; }
        i += (int64_t)len;
        return;
      }
      case 5: i += 4; if (i > n) fail = true; return;
      default: fail = true; return;
    }
  }
};

// valid UTF-8 with no control bytes (< 0x20)?
static bool clean_utf8(const unsigned char* p, int64_t m) {
  int64_t i = 0;
  while (i < m) {
    const unsigned char c = p[i];
    if (c < 0x20) return false;
    if (c < 0x80) { ++i; continue; }
    int need;
    unsigned char lo = 0x80, hi = 0xBF;
    if (c >= 0xC2 && c <= 0xDF) need = 1;
    else if (c == 0xE0) { need = 2; lo = 0xA0; }
    else if (c >= 0xE1 && c <= 0xEC) need = 2;
    else if (c == 0xED) { need = 2; hi = 0x9F; }
    else if (c == 0xEE || c == 0xEF) need = 2;
    else if (c == 0xF0) { need = 3; lo = 0x90; }
    else if (c >= 0xF1 && c <= 0xF3) need = 3;
    else if (c == 0xF4) { need = 3; hi = 0x8F; }
    else return false;
    if (i + need >= m) return false;
    if (p[i + 1] < lo || p[i + 1] > hi) return false;
    for (int k = 2; k <= need; ++k)
      if (p[i + k] < 0x80 || p[i + k] > 0xBF) return false;
    i += need + 1;
  }
  return true;
}

// Find the length-delimited field `fno` within [start, end): first or
// last occurrence (kubeproto._field vs decode_unknown semantics).
// Returns false on malformed wire (caller bails); absent field leaves
// *s == -1 and returns true.
static bool find_ld_field(const unsigned char* buf, int64_t start,
                          int64_t end, uint64_t fno, bool last_wins,
                          int64_t* s, int64_t* e) {
  PScan p{buf, end, start};
  *s = *e = -1;
  while (p.i < end) {
    const uint64_t tag = p.varint();
    if (p.fail) return false;
    const uint64_t f = tag >> 3;
    const int wt = (int)(tag & 7);
    if (f == fno && wt == 2 && (last_wins || *s < 0)) {
      const uint64_t len = p.varint();
      if (p.fail) return false;
      if (len > (uint64_t)(end - p.i)) return false;
      *s = p.i;
      *e = p.i + (int64_t)len;
      p.i = *e;
    } else {
      p.skip(wt);
      if (p.fail) return false;
    }
  }
  return true;
}

}  // namespace protoscan

extern "C" int64_t proto_list_spans(
    const char* buf_, int64_t n,
    int64_t* item_spans,  // [2*max_items] full chunk spans (tag included)
    char* key_buf,        // >= n + 3*max_items; '0' ns 0x1f name 0x1e
    int64_t* key_len, int64_t max_items) {
  using protoscan::PScan;
  const unsigned char* buf = (const unsigned char*)buf_;
  PScan sc{buf, n};
  *key_len = 0;
  int64_t count = 0;
  while (sc.i < n) {
    const int64_t tag_start = sc.i;
    const uint64_t tag = sc.varint();
    if (sc.fail) return -1;
    // field numbers compared at full 64-bit width: truncation could
    // alias a huge field number onto 2 and mis-key a chunk as an item
    const uint64_t fno = tag >> 3;
    const int wt = (int)(tag & 7);
    if (fno != 2 || wt != 2) {  // every XList: repeated items = field 2
      sc.skip(wt);
      if (sc.fail) return -1;
      continue;
    }
    const uint64_t ilen = sc.varint();
    if (sc.fail) return -1;
    if (ilen > (uint64_t)(n - sc.i)) return -1;
    const int64_t istart = sc.i, iend = sc.i + (int64_t)ilen;
    if (count >= max_items) return -2;  // caller grows and retries
    // first metadata (field 1) inside the item; within it the first
    // name (1) / namespace (3) — kubeproto._field semantics
    int64_t meta_s, meta_e;
    int64_t nm_s = -1, nm_e = -1, ns_s = -1, ns_e = -1;
    if (!protoscan::find_ld_field(buf, istart, iend, 1, false,
                                  &meta_s, &meta_e))
      return -1;
    if (meta_s >= 0) {
      if (!protoscan::find_ld_field(buf, meta_s, meta_e, 1, false,
                                    &nm_s, &nm_e))
        return -1;
      if (!protoscan::find_ld_field(buf, meta_s, meta_e, 3, false,
                                    &ns_s, &ns_e))
        return -1;
    }
    if (nm_s >= 0 &&
        !protoscan::clean_utf8(buf + nm_s, nm_e - nm_s))
      return -1;
    if (ns_s >= 0 &&
        !protoscan::clean_utf8(buf + ns_s, ns_e - ns_s))
      return -1;
    item_spans[2 * count] = tag_start;
    item_spans[2 * count + 1] = iend;
    char* kb = key_buf + *key_len;
    *kb++ = '0';
    if (ns_s >= 0) {
      memcpy(kb, buf + ns_s, (size_t)(ns_e - ns_s));
      kb += ns_e - ns_s;
    }
    *kb++ = '\x1f';
    if (nm_s >= 0) {
      memcpy(kb, buf + nm_s, (size_t)(nm_e - nm_s));
      kb += nm_e - nm_s;
    }
    *kb++ = '\x1e';
    *key_len = kb - key_buf;
    ++count;
    sc.i = iend;
  }
  return count;
}

// Protobuf Table scanner: rows = repeated field 3 of meta.k8s.io Table;
// each row's keyable object rides row.object (RawExtension, field 3)
// whose raw bytes (field 1, FIRST occurrence like kubeproto._field) are
// either a magic-prefixed runtime.Unknown (raw = field 2, LAST
// occurrence like kubeproto.decode_unknown) or a bare
// PartialObjectMetadata. Emits the same spans + key records as
// proto_list_spans. Bails (-1) on any row without a keyable object or
// with an empty name — the Python walker raises ProtoError there
// (clean 401) and keeps authority.
extern "C" int64_t proto_table_spans(
    const char* buf_, int64_t n,
    int64_t* item_spans, char* key_buf, int64_t* key_len,
    int64_t max_items) {
  using protoscan::PScan;
  const unsigned char* buf = (const unsigned char*)buf_;
  PScan sc{buf, n};
  *key_len = 0;
  int64_t count = 0;
  while (sc.i < n) {
    const int64_t tag_start = sc.i;
    const uint64_t tag = sc.varint();
    if (sc.fail) return -1;
    const uint64_t fno = tag >> 3;
    const int wt = (int)(tag & 7);
    if (fno != 3 || wt != 2) {  // Table: repeated rows = field 3
      sc.skip(wt);
      if (sc.fail) return -1;
      continue;
    }
    const uint64_t rlen = sc.varint();
    if (sc.fail) return -1;
    if (rlen > (uint64_t)(n - sc.i)) return -1;
    const int64_t rstart = sc.i, rend = sc.i + (int64_t)rlen;
    if (count >= max_items) return -2;
    // row.object -> RawExtension.raw -> (magic Unknown?) -> metadata
    // -> name/namespace, all via the shared bounded field finder
    int64_t ext_s, ext_e;
    if (!protoscan::find_ld_field(buf, rstart, rend, 3, false,
                                  &ext_s, &ext_e))
      return -1;
    if (ext_s < 0) return -1;  // no object: Python raises (401)
    int64_t raw_s, raw_e;
    if (!protoscan::find_ld_field(buf, ext_s, ext_e, 1, false,
                                  &raw_s, &raw_e))
      return -1;
    if (raw_s < 0) return -1;  // no raw bytes: Python raises
    // magic-prefixed Unknown? take its raw (field 2, LAST occurrence —
    // decode_unknown's loop overwrites)
    int64_t obj_s = raw_s, obj_e = raw_e;
    if (raw_e - raw_s >= 4 && memcmp(buf + raw_s, "k8s\x00", 4) == 0) {
      if (!protoscan::find_ld_field(buf, raw_s + 4, raw_e, 2, true,
                                    &obj_s, &obj_e))
        return -1;
      if (obj_s < 0) obj_s = obj_e = raw_s;  // no raw: empty object
    }
    int64_t meta_s, meta_e;
    int64_t nm_s = -1, nm_e = -1, ns_s = -1, ns_e = -1;
    if (!protoscan::find_ld_field(buf, obj_s, obj_e, 1, false,
                                  &meta_s, &meta_e))
      return -1;
    if (meta_s >= 0) {
      if (!protoscan::find_ld_field(buf, meta_s, meta_e, 1, false,
                                    &nm_s, &nm_e))
        return -1;
      if (!protoscan::find_ld_field(buf, meta_s, meta_e, 3, false,
                                    &ns_s, &ns_e))
        return -1;
    }
    if (nm_s < 0 || nm_e == nm_s) return -1;  // empty name: Python raises
    if (!protoscan::clean_utf8(buf + nm_s, nm_e - nm_s)) return -1;
    if (ns_s >= 0 &&
        !protoscan::clean_utf8(buf + ns_s, ns_e - ns_s))
      return -1;
    item_spans[2 * count] = tag_start;
    item_spans[2 * count + 1] = rend;
    char* kb = key_buf + *key_len;
    *kb++ = '0';
    if (ns_s >= 0) {
      memcpy(kb, buf + ns_s, (size_t)(ns_e - ns_s));
      kb += ns_e - ns_s;
    }
    *kb++ = '\x1f';
    memcpy(kb, buf + nm_s, (size_t)(nm_e - nm_s));
    kb += nm_e - nm_s;
    *kb++ = '\x1e';
    *key_len = kb - key_buf;
    ++count;
    sc.i = rend;
  }
  return count;
}
