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
// that distinct powers of two add without carries. This kernel sets each
// bit with atomicOr, which gives the same bits without that assumption: a
// duplicated position sets its bit once.
//
// The wrapper (ops/kernels.py expand_positions) zeroes the output, checks
// every slot against the starts table (0 <= slots[k] < len(starts) - 1)
// and trusts the build for 0 <= starts[s] <= starts[s + 1] <= len(pos),
// so no read here leaves an array; the shard and bit-position tests keep
// every write inside row k.
//
// Bound: bytes. Each position costs a load, two compares and one atomic
// on a word that is, for sparse rows, written once; the card is bound by
// reading the rows' positions once (4 B each), the slots and their two
// starts, and writing the [n, n_shards, width] output once (the zeroing
// is that write) over 3.35 TB/s (H100 SXM).
//
// Design (simple and right, not tuned). One warp per requested row: a
// fingerprint row holds about 48 positions, so a warp walks it in two
// coalesced loads, where a block would idle most of its threads. Lanes
// take consecutive positions, so the loads coalesce; the atomics of one
// row fall on at most n_shards * width words of that row and so do not
// collide with other warps' rows. Nothing carries between blocks. A long
// flat row (a dense-ish row of a multi-shard bank) simply loops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
expand_kernel(const uint32_t* __restrict__ pos,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ slots, uint32_t* __restrict__ out,
              long long n, long long n_shards, long long width) {
  const long long k = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (k >= n) return;
  const int lane = threadIdx.x & 31;
  const int32_t s = __ldg(slots + k);
  const long long lo = __ldg(starts + s);
  const long long hi = __ldg(starts + s + 1);
  const unsigned long long bits = (unsigned long long)width * 32ull;
  uint32_t* row = out + k * n_shards * width;
  for (long long j = lo + lane; j < hi; j += 32) {
    const uint32_t p = __ldg(pos + j);
    const uint32_t shard = p >> 16;
    const uint32_t bit = p & 0xFFFFu;
    if ((long long)shard < n_shards && (unsigned long long)bit < bits) {
      atomicOr(row + (long long)shard * width + (bit >> 5),
               1u << (bit & 31u));
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" {

int expand_positions(const void* pos, const void* starts, const void* slots,
                     void* out, long long n, long long n_shards,
                     long long width, void* stream) {
  if (n < 0 || n_shards < 0 || width < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || n_shards == 0 || width == 0) return 0;
  const long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  expand_kernel<<<(unsigned int)blocks, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(pos), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(slots), static_cast<uint32_t*>(out), n,
      n_shards, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
