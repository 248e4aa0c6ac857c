// Plan-buffer interpreter over a register slab, for Hopper (sm_90a).
//
//   mega_interpret   runs an int32 [P, 4] plan of (opcode, dst, a, b) rows
//       over a [T, S, W] u32 register slab, rows in order, and writes one
//       popcount per count lane: counts[j] = |slab[out_count[j]]|.
//       replaces pilosa_tpu/ops/pallas_kernels.py:337 mega_interpret
//       (_mega_loop_kernel) and the popcount of slab[out_count] that
//       pilosa_tpu/ops/megakernel.py build_program runs after it.
//
// Opcodes (pilosa_tpu_torch/ops/megakernel.py): 0 AND a&b, 1 OR a|b,
// 2 XOR a^b, 3 ANDNOT a&~b, 4 ZERO, 5 COPY a, 6 EXPAND a (identity, as in
// the JAX interpreter), 7 THRESH d|(a&b), which reads the current dst.
// Aliasing (dst == a, a == b) is legal: every operand is loaded before the
// result is stored. The wrapper (ops/kernels.py mega_interpret) has checked
// on the host that every opcode is in 0..7 and every register index is
// below T, so no index here can leave the slab. Pow2 pad rows
// (ZERO, spare, spare, spare) run like any other ZERO.
//
// The slab is updated IN PLACE: the caller's gather prologue made it a
// fresh tensor, and the final registers are what the row lanes read.
//
// Design. Instruction i reads what instruction i-1 wrote, but only within
// one word column: every opcode is elementwise over the flattened
// [T, n = S*W] slab. So each thread owns one column (a 16-byte vector of 4
// words when n % 4 == 0 and the slab is 16-byte aligned, else one word)
// and walks all P instructions over it; its own loads and stores keep the
// read-after-write chain in program order, with no grid-wide sync. The
// slab is read and written with plain loads and stores (never the
// read-only cache path, since the kernel writes it). Each block first
// stages the plan in shared memory, in chunks of PLAN_CHUNK rows. After
// the last instruction each thread popcounts its column of every count
// lane; a warp reduce, a shared-memory sum per block and one atomicAdd
// per (block, lane) build counts[j], which the caller zeroes. A lane's
// count is at most n*32, which the wrapper keeps below 2^32.
//
// Bound: the least bytes the card must move are the gathered registers
// read once (n_slots*S*W*4), the row lanes written once and the count
// lanes (4 bytes each), over 3.35 TB/s (H100 SXM). This simple design
// re-reads its operand registers from device memory or L2 on every
// instruction (2-3 reads and one write of 16 bytes per thread per
// instruction), so it moves about P*4*S*W*4 bytes. The next design keeps
// a tile of all T registers for a column range in shared memory (T
// registers x a column tile, up to 227 KB of dynamic shared memory a
// block), so each register crosses device memory at most once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PLAN_CHUNK = 1024;  // plan rows staged per pass (16 KB)
constexpr int LANE_CHUNK = 256;   // count lanes reduced per pass (2 KB)

enum : int {
  OP_AND = 0, OP_OR = 1, OP_XOR = 2, OP_ANDNOT = 3,
  OP_ZERO = 4, OP_COPY = 5, OP_EXPAND = 6, OP_THRESH = 7,
};

__device__ __forceinline__ uint4 v_and(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 v_or(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 v_xor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint4 v_andnot(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ __forceinline__ unsigned int v_popc(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint32_t v_and(uint32_t a, uint32_t b) { return a & b; }
__device__ __forceinline__ uint32_t v_or(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint32_t v_xor(uint32_t a, uint32_t b) { return a ^ b; }
__device__ __forceinline__ uint32_t v_andnot(uint32_t a, uint32_t b) { return a & ~b; }
__device__ __forceinline__ unsigned int v_popc(uint32_t v) { return __popc(v); }

template <typename V> __device__ __forceinline__ V v_zero();
template <> __device__ __forceinline__ uint4 v_zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ uint32_t v_zero<uint32_t>() {
  return 0u;
}

// V is uint4 (4 words a column) or uint32_t (1 word a column); `cols` is
// the number of V columns per register, slab holds T * cols of them.
template <typename V>
__global__ void __launch_bounds__(THREADS)
mega_interpret_kernel(V* slab, const int4* __restrict__ instrs,
                      const int* __restrict__ out_count,
                      unsigned int* __restrict__ counts,
                      long long cols, int n_instrs, int n_count) {
  __shared__ int4 s_plan[PLAN_CHUNK];
  __shared__ int s_lane[LANE_CHUNK];
  __shared__ unsigned int s_cnt[LANE_CHUNK];

  const long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = col < cols;
  V* base = slab + (active ? col : 0);

  for (int c0 = 0; c0 < n_instrs; c0 += PLAN_CHUNK) {
    const int m = min(PLAN_CHUNK, n_instrs - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < m; i += THREADS) s_plan[i] = instrs[c0 + i];
    __syncthreads();
    if (active) {
      for (int i = 0; i < m; ++i) {
        const int4 ins = s_plan[i];
        const int op = ins.x;
        V* dst = base + (long long)ins.y * cols;
        V r;
        if (op == OP_ZERO) {
          r = v_zero<V>();
        } else {
          const V a = base[(long long)ins.z * cols];
          if (op == OP_COPY || op == OP_EXPAND) {
            r = a;
          } else {
            const V b = base[(long long)ins.w * cols];
            switch (op) {
              case OP_AND: r = v_and(a, b); break;
              case OP_OR: r = v_or(a, b); break;
              case OP_XOR: r = v_xor(a, b); break;
              case OP_ANDNOT: r = v_andnot(a, b); break;
              default: r = v_or(*dst, v_and(a, b)); break;  // OP_THRESH
            }
          }
        }
        *dst = r;
      }
    }
  }

  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n_count; j0 += LANE_CHUNK) {
    const int m = min(LANE_CHUNK, n_count - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += THREADS) {
      s_lane[j] = out_count[j0 + j];
      s_cnt[j] = 0u;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      unsigned int v = active ? v_popc(base[(long long)s_lane[j] * cols]) : 0u;
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && v) atomicAdd(&s_cnt[j], v);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += THREADS) {
      if (s_cnt[j]) atomicAdd(&counts[j0 + j], s_cnt[j]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// counts must be zeroed by the caller (the kernel accumulates into it).
// Returns the launch's cudaError_t (0 on success).
extern "C" int mega_interpret(void* slab, const void* instrs,
                              const void* out_count, void* counts,
                              long long n_regs, long long n,
                              long long n_instrs, long long n_count,
                              void* stream) {
  if (n_regs <= 0 || n <= 0) return 0;
  if (n_instrs < 0 || n_instrs > 0x7fffffffLL || n_count < 0 ||
      n_count > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(instrs)) return (int)cudaErrorMisalignedAddress;
  const bool vec = (n % 4 == 0) && aligned16(slab);
  const long long cols = vec ? n / 4 : n;
  const long long blocks = (cols + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* ins = static_cast<const int4*>(instrs);
  const int* oc = static_cast<const int*>(out_count);
  unsigned int* cnt = static_cast<unsigned int*>(counts);
  if (vec) {
    mega_interpret_kernel<uint4><<<(unsigned int)blocks, THREADS, 0, s>>>(
        static_cast<uint4*>(slab), ins, oc, cnt, cols, (int)n_instrs,
        (int)n_count);
  } else {
    mega_interpret_kernel<uint32_t><<<(unsigned int)blocks, THREADS, 0, s>>>(
        static_cast<uint32_t*>(slab), ins, oc, cnt, cols, (int)n_instrs,
        (int)n_count);
  }
  return (int)cudaGetLastError();
}
