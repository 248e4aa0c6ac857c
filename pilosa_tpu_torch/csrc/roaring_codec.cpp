// roaring_codec: the host file codec of the port's fragments.
//
// The roaring file format (cookie 12348), its op-log replay and the
// checksums, as the JAX package's native library implements them
// (native/pilosa_native.cpp: rb_load, rb_serialize_ptrs,
// pn_serialize_groups, pn_fnv1a32, pn_dense_positions_ptrs, and the bulk
// import builder pn_import_build, pn_build_masks, pn_scatter_rows); a
// copy of those entry points only, so the port depends on nothing of the
// JAX package. The bytes written are those of the numpy codec in
// storage/roaring.py (the plain version). A snapshot container
// (rc_serialize) takes the smallest of the run, array and bitmap
// encodings, run first on a tie with nothing, array before bitmap; an
// import record's payload (rc_import_build, rc_serialize_groups,
// rc_serialize_import) is array below 4096 bits and bitmap from there,
// never run, as the JAX package's native builder writes it.
//
// File layout, little-endian:
//   u16 magic 12348, u16 version 0, u32 container count N
//   N x (u64 key, u16 type 1=array 2=bitmap 3=run, u16 cardinality-1)
//   N x u32 absolute payload offset
//   payloads: array = card x u16; bitmap = 1024 x u64;
//             run = u16 count, then count x (u16 start, u16 last)
//   op log to EOF: u8 type, u64 value, u32 checksum [, payload]
//     0 add / 1 remove: value = position, fnv1a32 over the 9 header bytes
//     2 add batch / 3 remove batch: value = count, count x u64 positions,
//       fnv1a32 over header and positions
//     4 add roaring: value = payload length, payload = a roaring file,
//       crc32 (zlib) over header and payload
//
// C interface only (ctypes). Built with g++ -O3 -std=c++17 -shared -fPIC
// -pthread by pilosa_tpu_torch/ops/build.py into build/native/<hash>/.
// The import builder and the groups writer split large batches over
// threads: PILOSA_NATIVE_THREADS of them (the JAX package's variable),
// by default the hardware's count capped at 8; the bytes do not depend
// on the count.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <mutex>
#include <new>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint16_t kMagic = 12348;
constexpr uint16_t kVersion = 0;
constexpr int kContainerWords = 1024;
constexpr int kHeaderBaseSize = 8;

constexpr uint16_t kTypeArray = 1;
constexpr uint16_t kTypeBitmap = 2;
constexpr uint16_t kTypeRun = 3;

constexpr uint8_t kOpAdd = 0;
constexpr uint8_t kOpRemove = 1;
constexpr uint8_t kOpAddBatch = 2;
constexpr uint8_t kOpRemoveBatch = 3;
constexpr uint8_t kOpAddRoaring = 4;

// Nesting bound of add-roaring records inside add-roaring payloads (the
// numpy reader's MAX_OP_NESTING): crafted input must not recurse without
// bound.
constexpr int kMaxOpNesting = 4;

inline uint16_t ru16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t ru32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t ru64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline void wu16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void wu32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline void wu64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

inline uint32_t fnv1a32(const uint8_t* data, size_t n, uint32_t h = 0x811C9DC5u) {
  for (size_t i = 0; i < n; i++) { h ^= data[i]; h *= 0x01000193u; }
  return h;
}

inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

// Worker count of the parallel import paths: PILOSA_NATIVE_THREADS
// (1..64), else the hardware's count capped at 8.
int native_threads() {
  static const int n = [] {
    const char* e = std::getenv("PILOSA_NATIVE_THREADS");
    if (e && *e) {
      int v = std::atoi(e);
      return v < 1 ? 1 : (v > 64 ? 64 : v);
    }
    unsigned hc = std::thread::hardware_concurrency();
    int v = static_cast<int>(hc ? hc : 1);
    return v > 8 ? 8 : v;
  }();
  return n;
}

// fn(lo, hi, t) over [0, n) in at most native_threads() contiguous
// chunks of at least `grain` items, chunk t the t-th range in order
// (callers concatenate per-chunk outputs in that order). Serial when one
// chunk suffices. An exception in a worker is rethrown here after every
// worker has joined; a chunk whose thread cannot start runs inline.
template <typename F>
void parallel_ranges(uint64_t n, uint64_t grain, F&& fn) {
  const uint64_t nt = static_cast<uint64_t>(native_threads());
  const uint64_t chunks = std::min<uint64_t>(nt, grain ? (n + grain - 1) / grain : 1);
  if (chunks <= 1) {
    fn(uint64_t{0}, n, uint64_t{0});
    return;
  }
  const uint64_t per = (n + chunks - 1) / chunks;
  std::vector<std::thread> ts;
  ts.reserve(chunks);
  std::exception_ptr err = nullptr;
  std::mutex err_mu;
  auto record = [&err, &err_mu]() {
    std::lock_guard<std::mutex> g(err_mu);
    if (!err) err = std::current_exception();
  };
  for (uint64_t t = 0; t < chunks; t++) {
    const uint64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    try {
      ts.emplace_back([&fn, &record, lo, hi, t] {
        try {
          fn(lo, hi, t);
        } catch (...) {
          record();
        }
      });
    } catch (...) {
      try {
        fn(lo, hi, t);
      } catch (...) {
        record();
      }
    }
  }
  for (auto& th : ts) th.join();
  if (err) std::rethrow_exception(err);
}

// crc32 (IEEE reflected, zlib's), slice-by-8, chainable as zlib.crc32.
struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++)
        t[s][i] = t[0][t[s - 1][i] & 0xFF] ^ (t[s - 1][i] >> 8);
  }
};

inline uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  static const Crc32Tables tables;
  const auto& t = tables.t;
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// ------------------------------------------------------------------ load

// A container of a loaded bitmap: a reference to an array (sorted,
// unique) or bitmap payload in the caller's buffer, or a dense block of
// the pool. Only containers an op touches become dense, so a sparse
// fragment with an op log loads at about its file size.
struct Cont {
  const uint8_t* p;  // payload (ref), or null for a dense block
  uint16_t typ;      // kTypeArray or kTypeBitmap for a ref
  uint32_t card;     // bits of a ref
  uint32_t block;    // pool block of a dense container
};

struct Loaded {
  std::vector<uint64_t> keys;    // snapshot keys, ascending
  std::vector<Cont> conts;       // parallel to keys
  std::vector<uint64_t> xkeys;   // keys first made by the op log
  std::vector<Cont> xconts;
  std::unordered_map<uint64_t, uint32_t> xindex;
  std::vector<uint64_t> pool;    // dense blocks, kContainerWords each
  std::vector<uint64_t> counts;  // final, parallel to keys
  uint64_t op_n = 0;
  uint64_t op_n_small = 0;
  uint64_t ops_bytes = 0;
  uint64_t snapshot_bytes = 0;
  uint64_t tail_dropped = 0;
  char err[128] = {0};

  uint64_t* block(uint32_t b) { return &pool[static_cast<size_t>(b) * kContainerWords]; }

  uint32_t new_block() {
    pool.resize(pool.size() + kContainerWords, 0);
    return static_cast<uint32_t>(pool.size() / kContainerWords - 1);
  }

  Cont* find(uint64_t key) {
    auto it = std::lower_bound(keys.begin(), keys.end(), key);
    if (it != keys.end() && *it == key) return &conts[it - keys.begin()];
    auto x = xindex.find(key);
    return x == xindex.end() ? nullptr : &xconts[x->second];
  }

  Cont* add(uint64_t key, const Cont& c) {
    xindex.emplace(key, static_cast<uint32_t>(xkeys.size()));
    xkeys.push_back(key);
    xconts.push_back(c);
    return &xconts.back();
  }

  // The container's words, made dense first if it is a ref.
  uint64_t* dense(Cont* c) {
    if (c->p) {
      uint32_t b = new_block();
      expand(*c, block(b));
      c->p = nullptr;
      c->block = b;
    }
    return block(c->block);
  }

  // ORs a container's bits into `out`.
  void expand(const Cont& c, uint64_t* out) const {
    if (!c.p) {
      const uint64_t* src = &pool[static_cast<size_t>(c.block) * kContainerWords];
      for (int w = 0; w < kContainerWords; w++) out[w] |= src[w];
    } else if (c.typ == kTypeArray) {
      for (uint32_t j = 0; j < c.card; j++) {
        uint16_t v = ru16(c.p + 2ull * j);
        out[v >> 6] |= 1ull << (v & 63);
      }
    } else {
      for (int w = 0; w < kContainerWords; w++) out[w] |= ru64(c.p + 8ull * w);
    }
  }
};

bool fail(Loaded* bm, const char* msg) {
  std::snprintf(bm->err, sizeof(bm->err), "%s", msg);
  return false;
}

inline void expand_runs(const uint8_t* data, uint32_t offset, uint16_t run_n,
                        uint64_t* dense) {
  for (uint16_t j = 0; j < run_n; j++) {
    uint16_t start = ru16(data + offset + 2 + 4ull * j);
    uint16_t last = ru16(data + offset + 2 + 4ull * j + 2);
    int w0 = start >> 6, w1 = last >> 6;
    for (int w = w0; w <= w1; w++) {
      uint64_t m = ~0ull;
      if (w == w0) m &= ~0ull << (start & 63);
      if (w == w1) m &= ~0ull >> (63 - (last & 63));
      dense[w] |= m;
    }
  }
}

inline bool any_bit(const uint64_t* d) {
  for (int w = 0; w < kContainerWords; w++) if (d[w]) return true;
  return false;
}

// The snapshot section: arrays with sorted unique payloads and bitmaps
// stay refs; other arrays and runs become dense. A container with no
// bit is not kept (the header's cardinality is not trusted). *ops_offset
// receives where the op log starts.
bool parse_snapshot(Loaded* bm, const uint8_t* data, size_t len, size_t* ops_offset) {
  if (len < kHeaderBaseSize) return fail(bm, "data too small");
  if (ru16(data) != kMagic) return fail(bm, "invalid roaring file magic");
  if (ru16(data + 2) != kVersion) return fail(bm, "wrong roaring version");
  uint32_t n = ru32(data + 4);
  size_t meta_pos = kHeaderBaseSize;
  size_t off_pos = meta_pos + 12ull * n;
  size_t payload_start = off_pos + 4ull * n;
  if (payload_start > len) return fail(bm, "truncated header");
  bm->keys.reserve(n);
  bm->conts.reserve(n);
  size_t ops = payload_start;
  uint64_t prev_key = 0;
  for (uint32_t i = 0; i < n; i++) {
    uint64_t key = ru64(data + meta_pos + 12ull * i);
    uint16_t typ = ru16(data + meta_pos + 12ull * i + 8);
    uint32_t card = static_cast<uint32_t>(ru16(data + meta_pos + 12ull * i + 10)) + 1;
    uint32_t offset = ru32(data + off_pos + 4ull * i);
    if (offset >= len) return fail(bm, "container offset out of bounds");
    if (i > 0 && key <= prev_key) return fail(bm, "container keys not sorted");
    prev_key = key;
    size_t end;
    Cont c{data + offset, typ, 0, 0};
    if (typ == kTypeArray) {
      end = offset + 2ull * card;
      if (end > len) return fail(bm, "array container truncated");
      bool sorted = true;
      for (uint32_t j = 1; j < card && sorted; j++)
        sorted = ru16(data + offset + 2ull * j) > ru16(data + offset + 2ull * (j - 1));
      c.card = card;
      if (!sorted) {
        uint32_t b = bm->new_block();
        bm->expand(c, bm->block(b));
        c = Cont{nullptr, 0, 0, b};
      }
    } else if (typ == kTypeBitmap) {
      end = offset + 8ull * kContainerWords;
      if (end > len) return fail(bm, "bitmap container truncated");
      uint64_t cnt = 0;
      for (int w = 0; w < kContainerWords; w++) cnt += popcount64(ru64(data + offset + 8ull * w));
      c.card = static_cast<uint32_t>(cnt);
    } else if (typ == kTypeRun) {
      if (offset + 2ull > len) return fail(bm, "run container truncated");
      uint16_t run_n = ru16(data + offset);
      end = offset + 2ull + 4ull * run_n;
      if (end > len) return fail(bm, "run container truncated");
      uint32_t b = bm->new_block();
      expand_runs(data, offset, run_n, bm->block(b));
      c = Cont{nullptr, 0, 0, b};
    } else {
      return fail(bm, "unknown container type");
    }
    if (end > ops) ops = end;
    if (c.p ? c.card == 0 : !any_bit(bm->block(c.block))) continue;
    bm->keys.push_back(key);
    bm->conts.push_back(c);
  }
  *ops_offset = ops;
  return true;
}

bool load(Loaded* bm, const uint8_t* data, size_t len, int depth);

inline void bit_add(Loaded* bm, uint64_t pos) {
  Cont* c = bm->find(pos >> 16);
  uint64_t* d;
  if (c) {
    d = bm->dense(c);
  } else {
    uint32_t b = bm->new_block();
    bm->add(pos >> 16, Cont{nullptr, 0, 0, b});
    d = bm->block(b);
  }
  d[(pos & 0xFFFF) >> 6] |= 1ull << (pos & 63);
}

inline void bit_remove(Loaded* bm, uint64_t pos) {
  Cont* c = bm->find(pos >> 16);
  if (c) bm->dense(c)[(pos & 0xFFFF) >> 6] &= ~(1ull << (pos & 63));
}

// A record running past EOF is a torn tail (a crash mid-append): it is
// dropped and its bytes reported in tail_dropped. A checksum mismatch on
// a whole record is corruption and fails.
bool replay_ops(Loaded* bm, const uint8_t* data, size_t len, size_t pos, int depth) {
  while (pos < len) {
    if (len - pos < 13) { bm->tail_dropped = len - pos; break; }
    uint8_t typ = data[pos];
    uint64_t value = ru64(data + pos + 1);
    uint32_t chk = ru32(data + pos + 9);
    if (typ == kOpAdd || typ == kOpRemove) {
      if (chk != fnv1a32(data + pos, 9)) return fail(bm, "op checksum mismatch");
      if (typ == kOpAdd) bit_add(bm, value); else bit_remove(bm, value);
      bm->op_n += 1;
      bm->op_n_small += 1;
      pos += 13;
      bm->ops_bytes += 13;
    } else if (typ == kOpAddBatch || typ == kOpRemoveBatch) {
      if (value > (len - pos - 13) / 8) { bm->tail_dropped = len - pos; break; }
      size_t size = 13 + 8ull * value;
      uint32_t h = fnv1a32(data + pos, 9);
      h = fnv1a32(data + pos + 13, 8ull * value, h);
      if (chk != h) return fail(bm, "op checksum mismatch");
      for (uint64_t j = 0; j < value; j++) {
        uint64_t v = ru64(data + pos + 13 + 8 * j);
        if (typ == kOpAddBatch) bit_add(bm, v); else bit_remove(bm, v);
      }
      bm->op_n += value;
      pos += size;
      bm->ops_bytes += size;
    } else if (typ == kOpAddRoaring) {
      if (value > len - pos - 13) { bm->tail_dropped = len - pos; break; }
      size_t size = 13 + value;
      uint32_t h = crc32_update(0, data + pos, 9);
      h = crc32_update(h, data + pos + 13, value);
      if (chk != h) return fail(bm, "op checksum mismatch");
      if (depth + 1 >= kMaxOpNesting) return fail(bm, "op nesting too deep");
      // The payload is a whole roaring file: its own op log replays too,
      // and a torn tail inside a checksummed payload is corruption.
      Loaded batch;
      if (!load(&batch, data + pos + 13, value, depth + 1)) return fail(bm, batch.err);
      if (batch.tail_dropped) return fail(bm, "op data truncated");
      for (size_t i = 0; i < batch.keys.size(); i++) {
        const Cont& bc = batch.conts[i];
        bm->op_n += batch.counts[i];
        Cont* c = bm->find(batch.keys[i]);
        if (c) {
          batch.expand(bc, bm->dense(c));
        } else if (bc.p) {
          bm->add(batch.keys[i], bc);  // a ref into the same buffer
        } else {
          uint32_t b = bm->new_block();
          batch.expand(bc, bm->block(b));
          bm->add(batch.keys[i], Cont{nullptr, 0, 0, b});
        }
      }
      pos += size;
      bm->ops_bytes += size;
    } else {
      return fail(bm, "invalid op type");
    }
  }
  return true;
}

// Sorted keys over the snapshot's and the op log's containers, each
// container's count, the empty ones dropped.
void finish(Loaded* bm) {
  std::vector<uint32_t> order(bm->xkeys.size());
  for (uint32_t i = 0; i < order.size(); i++) order[i] = i;
  std::sort(order.begin(), order.end(),
            [bm](uint32_t a, uint32_t b) { return bm->xkeys[a] < bm->xkeys[b]; });
  std::vector<uint64_t> keys;
  std::vector<Cont> conts;
  keys.reserve(bm->keys.size() + order.size());
  conts.reserve(keys.capacity());
  size_t i = 0, j = 0;
  while (i < bm->keys.size() || j < order.size()) {
    if (j >= order.size() || (i < bm->keys.size() && bm->keys[i] < bm->xkeys[order[j]])) {
      keys.push_back(bm->keys[i]);
      conts.push_back(bm->conts[i++]);
    } else {
      keys.push_back(bm->xkeys[order[j]]);
      conts.push_back(bm->xconts[order[j++]]);
    }
  }
  bm->keys.clear();
  bm->conts.clear();
  bm->counts.clear();
  for (size_t k = 0; k < keys.size(); k++) {
    const Cont& c = conts[k];
    uint64_t cnt = c.card;
    if (!c.p) {
      cnt = 0;
      const uint64_t* d = bm->block(c.block);
      for (int w = 0; w < kContainerWords; w++) cnt += popcount64(d[w]);
    }
    if (!cnt) continue;
    bm->keys.push_back(keys[k]);
    bm->conts.push_back(c);
    bm->counts.push_back(cnt);
  }
  bm->xkeys.clear();
  bm->xconts.clear();
  bm->xindex.clear();
}

bool load(Loaded* bm, const uint8_t* data, size_t len, int depth) {
  size_t ops_offset = 0;
  if (!parse_snapshot(bm, data, len, &ops_offset)) return false;
  bm->snapshot_bytes = ops_offset;
  if (!replay_ops(bm, data, len, ops_offset, depth)) return false;
  finish(bm);
  return true;
}

// ------------------------------------------------------------------ save

// One container handed to the writer: an array of `card` sorted unique
// u16 positions, or a dense 1024-word block.
struct Source {
  const uint16_t* arr;    // null for a dense container
  const uint64_t* dense;  // null for an array container
  uint64_t card;
};

// Cardinality and run count; the encoding follows from them exactly as
// the numpy writer chooses it.
inline void measure(const Source& s, uint64_t* card, uint64_t* runs) {
  if (s.arr) {
    *card = s.card;
    uint64_t r = s.card ? 1 : 0;
    for (uint64_t j = 1; j < s.card; j++)
      if (s.arr[j] != static_cast<uint16_t>(s.arr[j - 1] + 1)) r++;
    *runs = r;
    return;
  }
  uint64_t c = 0, r = 0, prev_msb = 0;
  for (int w = 0; w < kContainerWords; w++) {
    uint64_t x = s.dense[w];
    c += popcount64(x);
    r += popcount64(x & ~((x << 1) | prev_msb));
    prev_msb = x >> 63;
  }
  *card = c;
  *runs = r;
}

inline uint16_t choose(uint64_t card, uint64_t runs, uint64_t* psize) {
  uint64_t run_size = 2 + 4 * runs, array_size = 2 * card;
  if (run_size < array_size && run_size < 8192) { *psize = run_size; return kTypeRun; }
  if (array_size < 8192) { *psize = array_size; return kTypeArray; }
  *psize = 8192;
  return kTypeBitmap;
}

void write_payload(const Source& s, uint16_t typ, uint64_t runs, uint8_t* p) {
  if (typ == kTypeBitmap) {
    if (s.dense) {
      std::memcpy(p, s.dense, 8192);
    } else {
      uint64_t mask[kContainerWords];
      std::memset(mask, 0, sizeof(mask));
      for (uint64_t j = 0; j < s.card; j++) mask[s.arr[j] >> 6] |= 1ull << (s.arr[j] & 63);
      std::memcpy(p, mask, 8192);
    }
  } else if (typ == kTypeArray) {
    if (s.arr) {
      std::memcpy(p, s.arr, 2 * s.card);
    } else {
      size_t j = 0;
      for (int w = 0; w < kContainerWords; w++) {
        uint64_t x = s.dense[w];
        while (x) {
          wu16(p + 2 * j++, static_cast<uint16_t>((w << 6) | __builtin_ctzll(x)));
          x &= x - 1;
        }
      }
    }
  } else {
    wu16(p, static_cast<uint16_t>(runs));
    size_t j = 0;
    if (s.arr) {
      uint64_t start = s.arr[0];
      for (uint64_t k = 1; k <= s.card; k++) {
        if (k == s.card || s.arr[k] != static_cast<uint16_t>(s.arr[k - 1] + 1)) {
          wu16(p + 2 + 4 * j, static_cast<uint16_t>(start));
          wu16(p + 2 + 4 * j + 2, s.arr[k - 1]);
          j++;
          if (k < s.card) start = s.arr[k];
        }
      }
    } else {
      long start = -1;
      for (int w = 0; w < kContainerWords; w++) {
        uint64_t x = s.dense[w];
        if ((start < 0 && x == 0) || (start >= 0 && x == ~0ull)) continue;
        for (int b = 0; b < 64; b++) {
          bool set = (x >> b) & 1;
          long bit = (static_cast<long>(w) << 6) | b;
          if (set && start < 0) start = bit;
          if (!set && start >= 0) {
            wu16(p + 2 + 4 * j, static_cast<uint16_t>(start));
            wu16(p + 2 + 4 * j + 2, static_cast<uint16_t>(bit - 1));
            j++;
            start = -1;
          }
        }
      }
      if (start >= 0) {
        wu16(p + 2 + 4 * j, static_cast<uint16_t>(start));
        wu16(p + 2 + 4 * j + 2, static_cast<uint16_t>((kContainerWords << 6) - 1));
      }
    }
  }
}

inline Source source_of(uint64_t i, const uint16_t* lows, const uint64_t* arr_off,
                        const uint64_t* arr_len, const uint64_t* dense_ptrs) {
  if (arr_len[i]) return {lows + arr_off[i], nullptr, arr_len[i]};
  return {nullptr, reinterpret_cast<const uint64_t*>(dense_ptrs[i]), 0};
}

// ---------------------------------------------------------------- import

// The payload of an import record (a roaring file of the batch's bits):
// header, then per container key, type and cardinality - 1, its offset,
// and the payload: array below 4096 bits, bitmap from 4096. `dense(i)`
// gives container i's 1024 words, `card[i]` its bits (non-zero); `out`
// holds import_payload_size bytes. Containers fill in parallel, each a
// disjoint region.
uint64_t import_payload_size(const uint64_t* card, uint64_t m) {
  uint64_t total = kHeaderBaseSize + 16 * m;
  for (uint64_t i = 0; i < m; i++) total += card[i] < 4096 ? 2 * card[i] : 8192;
  return total;
}

template <typename Dense>
void write_import_payload(const uint64_t* keys, const uint64_t* card, uint64_t m,
                          Dense dense, uint8_t* out) {
  std::vector<uint64_t> offs(m + 1);
  offs[0] = kHeaderBaseSize + 16 * m;
  for (uint64_t i = 0; i < m; i++)
    offs[i + 1] = offs[i] + (card[i] < 4096 ? 2 * card[i] : 8192);
  wu16(out, kMagic);
  wu16(out + 2, kVersion);
  wu32(out + 4, static_cast<uint32_t>(m));
  const size_t meta_pos = kHeaderBaseSize;
  const size_t off_pos = meta_pos + 12 * m;
  parallel_ranges(m, 256, [&](uint64_t lo, uint64_t hi, uint64_t) {
    for (uint64_t i = lo; i < hi; i++) {
      const uint64_t* c = dense(i);
      uint16_t typ = card[i] < 4096 ? kTypeArray : kTypeBitmap;
      wu64(out + meta_pos + 12 * i, keys[i]);
      wu16(out + meta_pos + 12 * i + 8, typ);
      wu16(out + meta_pos + 12 * i + 10, static_cast<uint16_t>(card[i] - 1));
      wu32(out + off_pos + 4 * i, static_cast<uint32_t>(offs[i]));
      uint8_t* p = out + offs[i];
      if (typ == kTypeBitmap) {
        std::memcpy(p, c, 8192);
      } else {
        size_t j = 0;
        for (int w = 0; w < kContainerWords; w++) {
          uint64_t x = c[w];
          while (x) {
            wu16(p + 2 * j++, static_cast<uint16_t>((w << 6) | __builtin_ctzll(x)));
            x &= x - 1;
          }
        }
      }
    }
  });
}

// One bulk import batch: positions row << swidth_exp | (col mod
// 2^swidth_exp) scattered, without a sort, into dense masks over the
// whole container range of [min row, max row], then each container
// popcounted and, with want_payload, the import record's payload built.
// A batch unsuited to the dense scatter (row span of 2^17 containers or
// more, positions past 64 bits, fewer than 256 bits a container over a
// span of more than 64 containers) is declined with a non-empty err; the
// caller then sorts and groups it, as the JAX package's caller does.
struct ImportBuild {
  uint64_t* masks = nullptr;  // the whole container range, calloc'd
  uint64_t range = 0, kmin = 0;
  std::vector<uint64_t> keys;    // non-empty container keys, ascending
  std::vector<uint64_t> counts;  // bits a non-empty container
  std::vector<uint8_t> payload;
  uint64_t nbits = 0;
  char err[128] = {0};
  ~ImportBuild() { std::free(masks); }
};

void import_scatter(ImportBuild* ib, const uint64_t* rows, const uint64_t* cols,
                    uint64_t n, uint64_t rmin, uint32_t swidth_exp) {
  const uint64_t col_mask = (1ull << swidth_exp) - 1;
  // Threads split the output words, not the pairs: each reads every
  // pair and applies those in its stripe, so no two threads write one
  // cache line and no atomics are needed.
  if (native_threads() > 1 && n >= (1u << 20)) {
    parallel_ranges(ib->range * kContainerWords, 1u << 16,
                    [&](uint64_t wlo, uint64_t whi, uint64_t) {
      for (uint64_t i = 0; i < n; i++) {
        uint64_t p = ((rows[i] - rmin) << swidth_exp) + (cols[i] & col_mask);
        const uint64_t w = p >> 6;
        if (w >= wlo && w < whi) ib->masks[w] |= 1ull << (p & 63);
      }
    });
  } else {
    for (uint64_t i = 0; i < n; i++) {
      uint64_t p = ((rows[i] - rmin) << swidth_exp) + (cols[i] & col_mask);
      ib->masks[p >> 6] |= 1ull << (p & 63);
    }
  }
}

void import_count(ImportBuild* ib) {
  const uint64_t nt = static_cast<uint64_t>(native_threads());
  std::vector<std::vector<uint64_t>> skeys(nt), scounts(nt);
  parallel_ranges(ib->range, 512, [&](uint64_t lo, uint64_t hi, uint64_t t) {
    for (uint64_t k = lo; k < hi; k++) {
      const uint64_t* c = ib->masks + k * kContainerWords;
      uint64_t cnt = 0;
      for (int w = 0; w < kContainerWords; w++) cnt += popcount64(c[w]);
      if (cnt) {
        skeys[t].push_back(ib->kmin + k);
        scounts[t].push_back(cnt);
      }
    }
  });
  for (uint64_t t = 0; t < nt; t++) {
    ib->keys.insert(ib->keys.end(), skeys[t].begin(), skeys[t].end());
    ib->counts.insert(ib->counts.end(), scounts[t].begin(), scounts[t].end());
    for (uint64_t c : scounts[t]) ib->nbits += c;
  }
}

void* import_build(ImportBuild* ib, const uint64_t* rows, const uint64_t* cols,
                   uint64_t n, uint32_t swidth_exp, bool want_payload) {
  auto bail = [ib](const char* msg) -> void* {
    std::snprintf(ib->err, sizeof(ib->err), "%s", msg);
    return ib;
  };
  if (n == 0) return ib;
  if (swidth_exp < 16 || swidth_exp > 63) return bail("shard width below container width");
  uint64_t rmin = ~0ull, rmax = 0;
  for (uint64_t i = 0; i < n; i++) {
    if (rows[i] < rmin) rmin = rows[i];
    if (rows[i] > rmax) rmax = rows[i];
  }
  const uint64_t keys_per_row = 1ull << (swidth_exp - 16);
  if (rmax - rmin >= (1ull << 17) / keys_per_row)
    return bail("row range too wide for dense scatter");
  if (rmax >= (1ull << (64 - swidth_exp)))
    return bail("row id too large for 64-bit positions");
  const uint64_t range = (rmax - rmin + 1) * keys_per_row;
  if (range > 64 && n < range * 256) return bail("batch too sparse for dense scatter");
  ib->masks = static_cast<uint64_t*>(std::calloc(range * kContainerWords, 8));
  if (!ib->masks) return bail("out of memory");
  ib->range = range;
  ib->kmin = (rmin << swidth_exp) >> 16;
  import_scatter(ib, rows, cols, n, rmin, swidth_exp);
  import_count(ib);
  if (want_payload) {
    const uint64_t m = ib->keys.size();
    ib->payload.resize(import_payload_size(ib->counts.data(), m));
    write_import_payload(ib->keys.data(), ib->counts.data(), m,
                         [ib](uint64_t i) {
                           return ib->masks + (ib->keys[i] - ib->kmin) * kContainerWords;
                         },
                         ib->payload.data());
  }
  return ib;
}

}  // namespace

extern "C" {

// Parse a whole roaring file (snapshot and op log). Returns a handle, or
// null when out of memory; a non-empty rc_error is a refused file. The
// handle refers into `data` until rc_free.
void* rc_load(const uint8_t* data, uint64_t len) {
  auto* bm = new (std::nothrow) Loaded();
  if (!bm) return nullptr;
  try {
    load(bm, data, len, 0);
  } catch (const std::bad_alloc&) {
    fail(bm, "out of memory");
  }
  return bm;
}

const char* rc_error(void* h) { return static_cast<Loaded*>(h)->err; }
uint64_t rc_container_count(void* h) { return static_cast<Loaded*>(h)->keys.size(); }
uint64_t rc_op_n(void* h) { return static_cast<Loaded*>(h)->op_n; }
uint64_t rc_op_n_small(void* h) { return static_cast<Loaded*>(h)->op_n_small; }
uint64_t rc_ops_bytes(void* h) { return static_cast<Loaded*>(h)->ops_bytes; }
uint64_t rc_snapshot_bytes(void* h) { return static_cast<Loaded*>(h)->snapshot_bytes; }
uint64_t rc_tail_dropped(void* h) { return static_cast<Loaded*>(h)->tail_dropped; }
void rc_free(void* h) { delete static_cast<Loaded*>(h); }

void rc_keys(void* h, uint64_t* out) {
  auto* bm = static_cast<Loaded*>(h);
  std::memcpy(out, bm->keys.data(), 8 * bm->keys.size());
}

// Cardinality of each container, in key order.
void rc_counts(void* h, uint64_t* out) {
  auto* bm = static_cast<Loaded*>(h);
  std::memcpy(out, bm->counts.data(), 8 * bm->counts.size());
}

// Containers of at most `max_array_card` bits write their sorted
// positions into `lows_out` (concatenated in key order), the others
// their 1024 words into `dense_out` (key order).
void rc_export_split(void* h, uint64_t max_array_card, uint16_t* lows_out,
                     uint64_t* dense_out) {
  auto* bm = static_cast<Loaded*>(h);
  size_t lo = 0, dn = 0;
  uint64_t tmp[kContainerWords];
  for (size_t i = 0; i < bm->keys.size(); i++) {
    const Cont& c = bm->conts[i];
    if (bm->counts[i] <= max_array_card && c.p && c.typ == kTypeArray) {
      std::memcpy(lows_out + lo, c.p, 2ull * c.card);
      lo += c.card;
      continue;
    }
    const uint64_t* d;
    if (c.p) {
      std::memset(tmp, 0, sizeof(tmp));
      bm->expand(c, tmp);
      d = tmp;
    } else {
      d = bm->block(c.block);
    }
    if (bm->counts[i] <= max_array_card) {
      for (int w = 0; w < kContainerWords; w++) {
        uint64_t x = d[w];
        while (x) {
          lows_out[lo++] = static_cast<uint16_t>((w << 6) | __builtin_ctzll(x));
          x &= x - 1;
        }
      }
    } else {
      std::memcpy(dense_out + dn * kContainerWords, d, 8ull * kContainerWords);
      dn++;
    }
  }
}

// Serialize n non-empty containers with ascending keys. Container i is
// an array of arr_len[i] positions at lows + arr_off[i] when arr_len[i]
// is non-zero, else a dense block at address dense_ptrs[i].
// rc_serialize_size gives the exact byte count; rc_serialize writes it
// into `out` and returns it, or 0 for an empty dense container.
uint64_t rc_serialize_size(const uint16_t* lows, const uint64_t* arr_off,
                           const uint64_t* arr_len, const uint64_t* dense_ptrs,
                           uint64_t n) {
  uint64_t total = kHeaderBaseSize + 16 * n;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t card, runs, psize;
    measure(source_of(i, lows, arr_off, arr_len, dense_ptrs), &card, &runs);
    choose(card, runs, &psize);
    total += psize;
  }
  return total;
}

uint64_t rc_serialize(const uint64_t* keys, const uint16_t* lows,
                      const uint64_t* arr_off, const uint64_t* arr_len,
                      const uint64_t* dense_ptrs, uint64_t n, uint8_t* out) {
  wu16(out, kMagic);
  wu16(out + 2, kVersion);
  wu32(out + 4, static_cast<uint32_t>(n));
  const size_t meta_pos = kHeaderBaseSize;
  const size_t off_pos = meta_pos + 12 * n;
  uint64_t payload = off_pos + 4 * n;
  for (uint64_t i = 0; i < n; i++) {
    Source s = source_of(i, lows, arr_off, arr_len, dense_ptrs);
    uint64_t card, runs, psize;
    measure(s, &card, &runs);
    if (card == 0) return 0;
    uint16_t typ = choose(card, runs, &psize);
    wu64(out + meta_pos + 12 * i, keys[i]);
    wu16(out + meta_pos + 12 * i + 8, typ);
    wu16(out + meta_pos + 12 * i + 10, static_cast<uint16_t>(card - 1));
    wu32(out + off_pos + 4 * i, static_cast<uint32_t>(payload));
    write_payload(s, typ, runs, out + payload);
    payload += psize;
  }
  return payload;
}

// fnv1a32 over a buffer, chainable through `seed` (0x811C9DC5 to start).
uint32_t rc_fnv1a32(const uint8_t* data, uint64_t n, uint32_t seed) {
  return fnv1a32(data, n, seed);
}

// Set bits of n dense containers (addresses in `ptrs`): rc_popcount_ptrs
// counts them; rc_dense_positions_ptrs writes base[i] + bit index for
// each, container by container, and returns how many it wrote.
uint64_t rc_popcount_ptrs(const uint64_t* ptrs, uint64_t n) {
  uint64_t cnt = 0;
  for (uint64_t c = 0; c < n; c++) {
    const uint64_t* chunk = reinterpret_cast<const uint64_t*>(ptrs[c]);
    for (int w = 0; w < kContainerWords; w++) cnt += popcount64(chunk[w]);
  }
  return cnt;
}

uint64_t rc_dense_positions_ptrs(const uint64_t* ptrs, uint64_t n,
                                 const uint64_t* bases, uint64_t* out) {
  uint64_t cnt = 0;
  for (uint64_t c = 0; c < n; c++) {
    const uint64_t* chunk = reinterpret_cast<const uint64_t*>(ptrs[c]);
    for (int w = 0; w < kContainerWords; w++) {
      uint64_t x = chunk[w];
      uint64_t b = bases[c] + (static_cast<uint64_t>(w) << 6);
      while (x) {
        out[cnt++] = b + static_cast<uint64_t>(__builtin_ctzll(x));
        x &= x - 1;
      }
    }
  }
  return cnt;
}

// The bulk import builder (import_build above). Returns a handle, or
// null when out of memory; rc_ib_error non-empty means the batch was
// declined (or could not be built) and the caller takes the grouped
// path. The payload is built only with want_payload non-zero.
void* rc_import_build(const uint64_t* rows, const uint64_t* cols, uint64_t n,
                      uint32_t swidth_exp, int want_payload) {
  auto* ib = new (std::nothrow) ImportBuild();
  if (!ib) return nullptr;
  try {
    return import_build(ib, rows, cols, n, swidth_exp, want_payload != 0);
  } catch (...) {
    // Out of memory in a vector or a worker: declined, not a crash.
    std::snprintf(ib->err, sizeof(ib->err), "%s", "import build failed");
    return ib;
  }
}

const char* rc_ib_error(void* h) { return static_cast<ImportBuild*>(h)->err; }
uint64_t rc_ib_count(void* h) { return static_cast<ImportBuild*>(h)->keys.size(); }
uint64_t rc_ib_nbits(void* h) { return static_cast<ImportBuild*>(h)->nbits; }
uint64_t rc_ib_payload_size(void* h) { return static_cast<ImportBuild*>(h)->payload.size(); }

void rc_ib_keys_counts(void* h, uint64_t* keys_out, uint64_t* counts_out) {
  auto* ib = static_cast<ImportBuild*>(h);
  std::memcpy(keys_out, ib->keys.data(), 8 * ib->keys.size());
  std::memcpy(counts_out, ib->counts.data(), 8 * ib->counts.size());
}

// The non-empty containers' words, key order, into out[count * 1024].
void rc_ib_words(void* h, uint64_t* out) {
  auto* ib = static_cast<ImportBuild*>(h);
  parallel_ranges(ib->keys.size(), 256, [&](uint64_t lo, uint64_t hi, uint64_t) {
    for (uint64_t i = lo; i < hi; i++)
      std::memcpy(out + i * kContainerWords,
                  ib->masks + (ib->keys[i] - ib->kmin) * kContainerWords,
                  8 * kContainerWords);
  });
}

void rc_ib_payload(void* h, uint8_t* out) {
  auto* ib = static_cast<ImportBuild*>(h);
  std::memcpy(out, ib->payload.data(), ib->payload.size());
}

void rc_ib_free(void* h) { delete static_cast<ImportBuild*>(h); }

// An import record's payload from sorted unique positions grouped by
// container: keys[m] ascending, lows = every group's in-container
// positions back to back, bounds[m + 1] the groups' offsets into lows.
// `out` needs rc_serialize_groups_cap bytes. Returns the bytes written,
// 0 for a group that is empty or holds more than 65536 positions, ~0
// when the work could not run (out of memory).
uint64_t rc_serialize_groups_cap(uint64_t m, uint64_t n) {
  return kHeaderBaseSize + m * 16 + 4 * n + 8192;
}

uint64_t rc_serialize_groups(const uint64_t* keys, const uint16_t* lows,
                             const uint64_t* bounds, uint64_t m, uint8_t* out) {
  wu16(out, kMagic);
  wu16(out + 2, kVersion);
  wu32(out + 4, static_cast<uint32_t>(m));
  const size_t meta_pos = kHeaderBaseSize;
  const size_t off_pos = meta_pos + 12 * m;
  try {
    std::vector<uint64_t> offs(m + 1);
    offs[0] = off_pos + 4 * m;
    for (uint64_t i = 0; i < m; i++) {
      uint64_t card = bounds[i + 1] - bounds[i];
      if (card == 0 || card > 65536) return 0;
      offs[i + 1] = offs[i] + (card < 4096 ? 2 * card : 8192);
    }
    parallel_ranges(m, 2048, [&](uint64_t lo, uint64_t hi, uint64_t) {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t card = bounds[i + 1] - bounds[i];
        uint16_t typ = card < 4096 ? kTypeArray : kTypeBitmap;
        wu64(out + meta_pos + 12 * i, keys[i]);
        wu16(out + meta_pos + 12 * i + 8, typ);
        wu16(out + meta_pos + 12 * i + 10, static_cast<uint16_t>(card - 1));
        wu32(out + off_pos + 4 * i, static_cast<uint32_t>(offs[i]));
        if (typ == kTypeArray) {
          std::memcpy(out + offs[i], lows + bounds[i], 2 * card);
        } else {
          uint64_t mask[kContainerWords];
          std::memset(mask, 0, sizeof(mask));
          for (uint64_t j = bounds[i]; j < bounds[i + 1]; j++)
            mask[lows[j] >> 6] |= 1ull << (lows[j] & 63);
          std::memcpy(out + offs[i], mask, 8192);
        }
      }
    });
    return offs[m];
  } catch (...) {
    return ~0ull;
  }
}

// An import record's payload from m dense containers (addresses in
// `ptrs`, `card[i]` bits each, non-zero) under ascending `keys`; `out`
// needs rc_serialize_import_size bytes. Returns the bytes written, ~0
// when the work could not run.
uint64_t rc_serialize_import_size(const uint64_t* card, uint64_t m) {
  return import_payload_size(card, m);
}

uint64_t rc_serialize_import(const uint64_t* keys, const uint64_t* ptrs,
                             const uint64_t* card, uint64_t m, uint8_t* out) {
  try {
    write_import_payload(keys, card, m,
                         [ptrs](uint64_t i) { return reinterpret_cast<const uint64_t*>(ptrs[i]); },
                         out);
  } catch (...) {
    return ~0ull;
  }
  return import_payload_size(card, m);
}

// Dense container masks from sorted positions grouped by pos >> 16:
// keys_out[m], words_out[m * 1024] (zeroed by the caller; m the distinct
// key count). Returns the groups written, 0 when there are more than m.
uint64_t rc_build_masks(const uint64_t* positions, uint64_t n, uint64_t m,
                        uint64_t* keys_out, uint64_t* words_out) {
  if (n == 0 || m == 0) return 0;
  uint64_t w = 0;
  uint64_t cur = positions[0] >> 16;
  keys_out[0] = cur;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t key = positions[i] >> 16;
    if (key != cur) {
      if (++w >= m) return 0;
      keys_out[w] = key;
      cur = key;
    }
    uint64_t low = positions[i] & 0xFFFF;
    words_out[w * kContainerWords + (low >> 6)] |= 1ull << (low & 63);
  }
  return w + 1;
}

// ORs rows of in-container u16 positions into a [*, words64] u64 block:
// pos holds the rows' positions back to back, lens[r] of row r, which
// lands in row row_index[r] of `out`. Positions at or past words64 * 64
// are skipped (banks trimmed below a container's width).
void rc_scatter_rows(const uint16_t* pos, const uint64_t* lens, uint64_t rows,
                     const uint64_t* row_index, uint64_t words64, uint64_t* out) {
  uint64_t off = 0;
  for (uint64_t r = 0; r < rows; r++) {
    uint64_t* row = out + row_index[r] * words64;
    for (uint64_t j = 0; j < lens[r]; j++) {
      uint16_t p = pos[off + j];
      if (static_cast<uint64_t>(p >> 6) < words64) row[p >> 6] |= 1ull << (p & 63);
    }
    off += lens[r];
  }
}

}  // extern "C"
