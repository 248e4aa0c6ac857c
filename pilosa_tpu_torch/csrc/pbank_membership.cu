// Membership counts over a positions bank, for Hopper (sm_90a).
//
//   pbank_membership_counts   out[r] = |{p in row r : bit p of filt is set}|
//       replaces pilosa_tpu/ops/pallas_kernels.py pbank_membership_counts
//       (_membership_kernel), the function the JAX executor computes with
//       jnp membership forms in Executor._pbank_kernel: |row ∧ filter| per
//       row of a positions-bank segment, for filtered and Tanimoto TopN.
//
// Layouts (core/view.py PositionsBank), one entry point for both:
//   fixed (starts == NULL): pos [rows, L] u16, each row padded with 0xFFFF;
//   flat: pos [P] u16, row r is pos[starts[r] .. starts[r + 1]).
// The filter is W <= 2047 words (bit p in word p >> 5), already cut to the
// bank's width by the caller.
//
// Bound: bytes. Each position costs one shared-memory bit test and an add,
// far below the card's integer rate, so the kernel is bound by reading the
// positions once: rows*L*2 + rows*4 bytes for the fixed layout (P*2 +
// (rows+1)*4 + rows*4 for the flat one) over 3.35 TB/s (H100 SXM).
//
// Design. Each block stages the whole filter (at most 8 KB) in shared
// memory, so a position is one bit test whatever the filter's density:
// the TPU kernel's unrolled compare against <= 1024 query positions and
// the jnp gather both become this, and no sparse-filter gate is needed. A
// word index p >> 5 that is >= W counts 0: the pad position 0xFFFF has
// word 2047 >= W, so pads match nothing by an explicit check. One thread
// per row sums in a register and stores one int32. Fixed rows whose byte
// length is a multiple of 16 (L % 8 == 0, the fingerprint shape L = 48)
// are read with 16-byte loads, eight positions each; other rows one
// position per load. Nothing carries between blocks, so blocks run in any
// order. Simple first: no TMA, no warp-per-row split of long flat rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_WORDS = 2047;

__device__ __forceinline__ int member(const uint32_t* sf, uint32_t w_count,
                                      uint32_t p) {
  const uint32_t w = p >> 5;
  return w < w_count ? (int)((sf[w] >> (p & 31u)) & 1u) : 0;
}

__device__ __forceinline__ int member2(const uint32_t* sf, uint32_t w_count,
                                       uint32_t pair) {
  return member(sf, w_count, pair & 0xFFFFu) + member(sf, w_count, pair >> 16);
}

template <bool VEC8>
__global__ void __launch_bounds__(THREADS)
membership_kernel(const uint16_t* __restrict__ pos,
                  const int32_t* __restrict__ starts,
                  const uint32_t* __restrict__ filt,
                  int32_t* __restrict__ out, long long rows, long long L,
                  int W) {
  __shared__ uint32_t sf[MAX_WORDS];
  for (int i = threadIdx.x; i < W; i += THREADS) sf[i] = __ldg(filt + i);
  __syncthreads();
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  const uint32_t w_count = (uint32_t)W;
  int acc = 0;
  if (VEC8) {
    const uint4* row = reinterpret_cast<const uint4*>(pos + r * L);
    for (long long j = 0; j < L / 8; ++j) {
      const uint4 v = __ldg(row + j);
      acc += member2(sf, w_count, v.x) + member2(sf, w_count, v.y) +
             member2(sf, w_count, v.z) + member2(sf, w_count, v.w);
    }
  } else {
    long long lo, hi;
    if (starts != nullptr) {
      lo = __ldg(starts + r);
      hi = __ldg(starts + r + 1);
    } else {
      lo = r * L;
      hi = lo + L;
    }
    for (long long j = lo; j < hi; ++j) acc += member(sf, w_count, __ldg(pos + j));
  }
  out[r] = acc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Each entry returns the launch's cudaError_t (0 on success).
extern "C" {

int pbank_membership_counts(const void* pos, const void* starts,
                            const void* filt, void* out, long long rows,
                            long long L, long long W, void* stream) {
  if (W < 0 || W > MAX_WORDS || L < 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const long long blocks = (rows + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* p = static_cast<const uint16_t*>(pos);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const uint32_t* f = static_cast<const uint32_t*>(filt);
  int32_t* o = static_cast<int32_t*>(out);
  if (st == nullptr && L % 8 == 0 && aligned16(pos)) {
    membership_kernel<true><<<(unsigned int)blocks, THREADS, 0, s>>>(
        p, st, f, o, rows, L, (int)W);
  } else {
    membership_kernel<false><<<(unsigned int)blocks, THREADS, 0, s>>>(
        p, st, f, o, rows, L, (int)W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
