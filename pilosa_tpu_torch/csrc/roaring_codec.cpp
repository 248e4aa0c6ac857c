// roaring_codec: the host file codec of the port's fragments.
//
// The roaring file format (cookie 12348), its op-log replay and the
// checksums, as the JAX package's native library implements them
// (native/pilosa_native.cpp: rb_load, rb_serialize_ptrs,
// pn_serialize_groups, pn_fnv1a32, pn_dense_positions_ptrs); a copy of
// those entry points only, so the port depends on nothing of the JAX
// package. The bytes written are those of the numpy codec in
// storage/roaring.py (the plain version): each container takes the
// smallest of the run, array and bitmap encodings, run first on a tie
// with nothing, array before bitmap.
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
// by pilosa_tpu_torch/ops/build.py into build/native/<hash>/.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
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

}  // extern "C"
