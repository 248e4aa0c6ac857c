// Sparse-bank expansion, for Hopper (sm_90a).
//
//   expand_positions   out[k] ([n_shards, width] int32 words) has bit
//       (bitpos & 31) of word (shard, bitpos >> 5) set for every encoded
//       position p = pos[j] = (shard << 16) | bitpos with
//       starts[slots[k]] <= j < starts[slots[k] + 1], shard < n_shards
//       and bitpos < width * 32; every other bit is 0.
//       replaces pilosa_tpu/ops/megakernel.py:106 expand_positions (the
//       XLA scatter of one sparse-bank row, vmapped over a slot list in
//       build_program(...).run) and pilosa_tpu/core/view.py:41
//       _expand_sparse_chunk (the sparse upload of a dense bank: the
//       case n_shards = 1, starts the exclusive prefix sum of the rows'
//       lengths, slots = 0..cap-1). Neither is a Pallas kernel.
//
// The JAX scatter ADDS each bit into its word and relies on the
// positions of one (row, shard) being unique (container arrays are), so
// that distinct powers of two add without carries. This kernel ORs each
// bit into a shared-memory word, which gives the same bits without that
// assumption: a duplicated position sets its bit once. Nor does it rely
// on the positions of a row being sorted.
//
// The wrapper (ops/kernels.py expand_positions) checks every slot
// against the starts table (0 <= slots[k] < len(starts) - 1) and trusts
// the build for 0 <= starts[s] <= starts[s + 1] <= len(pos), so no read
// here leaves an array; the shard, bit-position and tile tests keep every
// write inside its own tile of row k.
//
// Bound. At the sparse upload of a large bank: bytes, the rows'
// positions read once (4 B each), the slots and their two offsets, and
// the [n, n_shards, width] output written once, over 3.35 TB/s (H100
// SXM). At the shape of a burst's expansion ([65, 1, 128]: 33 KB out,
// about 3,100 positions) and of an eager Row leaf, that is nanoseconds:
// one launch's latency bounds it.
//
// Design. The earlier kernel cost a call three device operations and
// one host stall: a fill kernel zeroing the output, a pageable (so
// blocking) copy of the slot list, and a kernel doing one global
// atomicOr per position into the words the fill had just written. Here:
//
// - One launch, and every output word is written exactly once, from
//   shared memory. A block owns output tiles: runs of tile_words
//   contiguous words of one row's flattened [n_shards * width] words.
//   It zeroes its tiles in shared memory, walks each tile's row's
//   positions with coalesced loads, ORs the ones that fall in the tile
//   into shared memory with a shared atomicOr, syncs, and stores the
//   tile with 16-byte stores (scalar stores for the words before the
//   first 16-byte boundary and after the last). The wrapper allocates
//   the output with torch.empty: there is no fill.
// - Rows of at most one tile (the burst's 512 B rows, the upload's rows
//   of at most 8 KB) are packed units_per_block to a block, each to a
//   group of THREADS / units_per_block threads (at least 8), but only as
//   far as the grid keeps two blocks an SM: a burst's 65 rows take 65
//   blocks, so each row's dependent loads (its slot, its two offsets,
//   its positions) are walked by a whole block, while 65,536 upload rows
//   take 2,048 blocks of 32, which keeps several loads a thread in
//   flight (the position loop is unrolled) and spares 6,144 blocks'
//   start-up. A row wider than a tile (an eager Row leaf on a 96-shard
//   view: 196,608 words) spans tiles_per_row tiles, one to a block, and
//   each of them walks the row's positions again; the second walk hits
//   L2.
// - A row's offsets are loaded before its tile is zeroed, so the zeroing
//   runs under their latency. What remains at a burst's shape is the
//   chain slot -> offsets -> positions -> store: two dependent loads
//   where index_add_ over precomputed word indexes has one.
// - The slots reach the kernel without a blocking copy: a contiguous
//   range (the upload's 0..cap-1, one slot) as its first slot; a list of
//   at most PARAM_SLOTS in the launch's own parameters (a struct by
//   value, filled here from the host pointer the wrapper passes, read
//   in place as a __grid_constant__); a longer list from device memory,
//   which the wrapper fills with a non-blocking copy from pinned memory
//   on the launch's stream.
// - The launch geometry (tile_words, tiles_per_row, units_per_block)
//   comes from the wrapper's expand_geometry; this entry checks that it
//   keeps every tile inside the block's shared memory and gives each
//   group at least 8 threads (the first 16-byte boundary of a tile lies
//   at most 3 words in).
//
// launch_floor launches an empty kernel: the yardstick a launch-bound
// expansion is timed against.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
// 32 KB of static shared memory a block: seven blocks fit an SM.
constexpr int TILE_WORDS = 8192;
// Slots carried in the launch's parameters: 2 KB, well inside the
// classic 4 KB parameter limit with the other arguments.
constexpr int PARAM_SLOTS = 512;

constexpr int SLOTS_RANGE = 0;
constexpr int SLOTS_PARAM = 1;
constexpr int SLOTS_DEVICE = 2;

struct SlotParam {
  int32_t s[PARAM_SLOTS];
};

__global__ void __launch_bounds__(THREADS)
expand_kernel(const uint32_t* __restrict__ pos,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ dev_slots,
              const __grid_constant__ SlotParam param, int mode,
              int slot_lo, uint32_t* __restrict__ out, long long n,
              int n_shards, int width, long long row_words, int tile_words,
              int tiles_per_row, int units_per_block) {
  __shared__ __align__(16) uint32_t tile[TILE_WORDS];
  const int group_threads = THREADS / units_per_block;
  const int group = threadIdx.x / group_threads;
  const int g = threadIdx.x - group * group_threads;
  const long long unit = (long long)blockIdx.x * units_per_block + group;
  const bool live = unit < n * tiles_per_row;
  uint32_t* slice = tile + group * tile_words;

  // The row's offsets are loaded before the tile is zeroed, so the
  // zeroing runs under their latency.
  long long k = 0, t0 = 0, lo = 0, hi = 0;
  int len = 0;
  if (live) {
    k = unit / tiles_per_row;
    t0 = (unit - k * tiles_per_row) * (long long)tile_words;
    const long long left = row_words - t0;
    len = left < tile_words ? (int)left : tile_words;
    const int s = mode == SLOTS_RANGE ? slot_lo + (int)k
                  : mode == SLOTS_PARAM ? param.s[k]
                                        : __ldg(dev_slots + k);
    lo = __ldg(starts + s);
    hi = __ldg(starts + s + 1);
  }
  for (int i = g * 4; i < tile_words; i += group_threads * 4) {
    *reinterpret_cast<uint4*>(slice + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  if (live) {
    const uint32_t bits = (uint32_t)width * 32u;
#pragma unroll 4
    for (long long j = lo + g; j < hi; j += group_threads) {
      const uint32_t p = __ldg(pos + j);
      const uint32_t shard = p >> 16;
      const uint32_t bit = p & 0xFFFFu;
      if (shard < (uint32_t)n_shards && bit < bits) {
        const long long w = (long long)shard * width + (bit >> 5) - t0;
        if (w >= 0 && w < len) {
          atomicOr(slice + w, 1u << (bit & 31u));
        }
      }
    }
  }
  __syncthreads();
  if (!live) return;

  // The output is 16-byte aligned (torch.empty), so word `at` of it is
  // on a 16-byte boundary when at % 4 == 0.
  const long long at = k * row_words + t0;
  uint32_t* dst = out + at;
  int head = (int)((4 - (at & 3)) & 3);
  if (head > len) head = len;
  const int body_end = head + ((len - head) & ~3);
  if (g < head) dst[g] = slice[g];
  for (int i = head + g * 4; i < body_end; i += group_threads * 4) {
    *reinterpret_cast<uint4*>(dst + i) =
        make_uint4(slice[i], slice[i + 1], slice[i + 2], slice[i + 3]);
  }
  for (int i = body_end + g; i < len; i += group_threads) dst[i] = slice[i];
}

__global__ void noop_kernel() {}

}  // namespace

// Each returns the launch's cudaError_t (0 on success).
extern "C" {

// slots: host_slots (n int32 on the host, n <= PARAM_SLOTS) travel in
// the parameters; else dev_slots (n int32 on the device); else the range
// slot_lo .. slot_lo + n - 1.
int expand_positions(const void* pos, const void* starts,
                     const void* dev_slots, const void* host_slots,
                     long long slot_lo, void* out, long long n,
                     long long n_shards, long long width,
                     long long tile_words, long long tiles_per_row,
                     long long units_per_block, void* stream) {
  if (n < 0 || n_shards < 0 || width < 0 || slot_lo < 0 ||
      slot_lo > 0x7fffffffLL - n || n_shards > 0x7fffffffLL ||
      width * 32 > (1LL << 31) || ((uintptr_t)out & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || n_shards == 0 || width == 0) return 0;
  const long long row_words = n_shards * width;
  if (tile_words < 4 || tile_words % 4 != 0 || units_per_block < 1 ||
      THREADS % units_per_block != 0 || THREADS / units_per_block < 8 ||
      tile_words * units_per_block > TILE_WORDS || tiles_per_row < 1 ||
      tiles_per_row * tile_words < row_words ||
      (tiles_per_row - 1) * tile_words >= row_words) {
    return (int)cudaErrorInvalidValue;
  }
  SlotParam param;
  int mode = SLOTS_RANGE;
  if (host_slots != nullptr) {
    if (n > PARAM_SLOTS) return (int)cudaErrorInvalidValue;
    memcpy(param.s, host_slots, (size_t)n * sizeof(int32_t));
    mode = SLOTS_PARAM;
  } else if (dev_slots != nullptr) {
    mode = SLOTS_DEVICE;
  }
  const long long units = n * tiles_per_row;
  const long long blocks = (units + units_per_block - 1) / units_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  expand_kernel<<<(unsigned int)blocks, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(pos), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(dev_slots), param, mode, (int)slot_lo,
      static_cast<uint32_t*>(out), n, (int)n_shards, (int)width, row_words,
      (int)tile_words, (int)tiles_per_row, (int)units_per_block);
  return (int)cudaGetLastError();
}

int launch_floor(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
