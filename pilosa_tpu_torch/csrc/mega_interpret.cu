// Plan-buffer interpreter over the register file of a column tile, for
// Hopper (sm_90a). One launch runs the whole of the JAX package's
// build_program(...).run: the gather of the slot rows, the width mask,
// the zeroed scratch, the plan, the count-lane popcounts and the row
// lanes.
//
//   mega_interpret   register r < n_slots is slot row r of its bank
//       (slots[r].base, S shards of slots[r].w_bank words) fitted to the
//       launch width w_mega and masked to the entry's plan width: word
//       (s, w) is base[s * w_bank + w] when w < slots[r].valid =
//       min(w_bank, width), else 0. Registers n_slots..T-1 start at 0.
//       The int32 [P, 4] plan of (opcode, dst, a, b) rows runs in order;
//       then counts[j] = |reg[out_count[j]]| and rows[j] =
//       reg[out_row[j]] ([Nr, S, w_mega]).
//       replaces pilosa_tpu/ops/pallas_kernels.py:337 mega_interpret
//       (_mega_loop_kernel) and the rest of
//       pilosa_tpu/ops/megakernel.py:1221 run (gather, mask, popcount of
//       the count lanes, selection of the row lanes).
//
// Opcodes (pilosa_tpu_torch/ops/megakernel.py): 0 AND a&b, 1 OR a|b,
// 2 XOR a^b, 3 ANDNOT a&~b, 4 ZERO, 5 COPY a, 6 EXPAND a (identity, as in
// the JAX interpreter), 7 THRESH d|(a&b), which reads the current dst.
// Aliasing (dst == a, a == b) is legal: every operand is loaded before the
// result is stored. The wrapper (ops/kernels.py mega_interpret) has
// checked on the host every opcode, register and lane index against T,
// every slot against its bank and every width against [1, w_mega], so no
// index here leaves the tile or a bank row. It passes only the plan's
// live prefix: a trailing run of ZERO rows into scratch registers that no
// earlier row wrote is dropped (the pow2 pad rows, ZERO into the spare
// register T-1, are such a run unless a real row writes the spare), which
// leaves every output lane, pad lanes included, bit-identical.
//
// Design. Every opcode is elementwise over the flattened n = S*w_mega
// word columns, so plan row i reads what row i-1 wrote only within one
// column. A block owns a tile of C consecutive columns and holds all T
// registers of it in dynamic shared memory, laid out [T][C] (T*C*4
// bytes, so a warp's neighbouring words fall in distinct banks). Each
// thread owns VW consecutive words (a uint4, uint2 or one word: VW
// divides w_mega, so its words lie in one shard) of every register. A
// block first stages the slot descriptors, the plan rows (as opcode truth
// tables and register byte offsets) and the lane indexes in shared memory:
// read from global memory inside the loops, each would put a cache round
// trip on the path of every plan row. Then, per tile:
//   1. each thread gathers its words of the n_slots slot registers
//      straight from the banks with cp.async (16 or 8 bytes when the bank
//      row allows, else 4), the width mask applied through the src-size
//      operand (zero fill), and zeroes its words of the scratch registers;
//      cp.async.wait_all then makes its own copies visible to it;
//   2. it walks the plan over its words. Program order inside the thread
//      is the read-after-write chain, so the loop has no barrier. The loop
//      has no branch either: every opcode is one truth table over (a, b)
//      plus the old dst for THRESH, so a plan row costs two or three
//      shared loads, a few logic ops and one store. Plans longer than
//      PLAN_CAP rows are staged a chunk at a time, between barriers;
//   3. it stores its words of each row lane (coalesced) and adds the
//      popcount of its words of each of the first REG_LANES count lanes
//      into a register; further lanes take a warp reduce and an atomic
//      per tile.
// The grid is persistent: a few blocks per SM walk the column tiles, and
// after its last tile each warp reduces its registers and adds one atomic
// per count lane into counts (zeroed by the caller). A lane's count is at
// most n*32, which the wrapper keeps below 2^32.
//
// Choosing C and VW. Shared memory caps the columns resident on an SM at
// about 228 KB / (T*4); at T = 64 each thread's plan row is a chain of
// shared-memory round trips, so the SM needs every warp that fits. C is
// the largest power of two up to 1024 words (and 256 threads) for which
// two blocks fit an SM (T*C*4 plus what is staged within half of its 228
// KB); VW is the widest that divides w_mega and still gives a block four
// warps where C allows. At T = 64: C = 256 words, 64 KB, VW = 2, 128
// threads, three blocks an SM, so one block's gather overlaps the
// others' plans. At the smallest tile, C = 32 words, T*128 bytes and the
// most that may be staged must fit the 227 KB a block may take: T <= 1704
// (1024 after the pow2 padding), the wrapper's MEGA_MAX_REGS.
//
// Bounds. Device memory: the gathered rows read once (n_slots*n*4), the
// row lanes written once and the count lanes, over 3.35 TB/s (H100 SXM);
// 0.113 ms on the taxi burst's plan (29 slots, one row lane, S = 96,
// w_mega = 32768). Shared memory: every executed plan row reads two or
// three words and writes one a column, about 132 x 3 x 4 B x 3.15M = 5 GB
// on that plan, over 132 SMs x 128 B/clk (about 30 TB/s near 1.75 GHz):
// about 0.18 ms, which binds this design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE_WORDS = 1024;
constexpr int MIN_TILE_WORDS = 32;
// Staged in shared memory once per block: up to SLOT_CAP slot
// descriptors, PLAN_CAP plan rows, and LANE_CAP count-lane and row-lane
// indexes (past a cap, slots and lanes are read from global memory where
// they are used, and the plan a chunk at a time).
constexpr int SLOT_CAP = 256;
constexpr int PLAN_CAP = 512;
constexpr int LANE_CAP = 256;
constexpr int REG_LANES = 32;  // count lanes summed in registers
constexpr int MAX_BLOCK_SMEM = 232448;               // 227 KB a block
constexpr int TWO_BLOCK_SMEM = 233472 / 2 - 1024;    // half an SM, less
                                                     // the block reserve

// One slot register: its bank row (S shards of w_bank words) and how many
// leading words of each shard it keeps, min(w_bank, plan width). 16 bytes,
// as the wrapper packs it: int64 base, then int32 w_bank, int32 valid.
struct alignas(16) SlotDesc {
  unsigned long long base;
  int w_bank;
  int valid;
};

__device__ __forceinline__ unsigned int v_popc(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ unsigned int v_popc(uint2 v) {
  return __popc(v.x) + __popc(v.y);
}

__device__ __forceinline__ unsigned int v_popc(uint32_t v) { return __popc(v); }

template <typename V> __device__ __forceinline__ V v_zero();
template <> __device__ __forceinline__ uint4 v_zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ uint2 v_zero<uint2>() {
  return make_uint2(0u, 0u);
}
template <> __device__ __forceinline__ uint32_t v_zero<uint32_t>() {
  return 0u;
}

// cp.async of `bytes` (4, 8 or 16) from global to shared memory; the
// first `src_bytes` come from src, the rest of the destination is zeroed.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A plan row as the loop reads it: the opcode's truth table (bit 0 keeps
// a&b, bit 1 a&~b, bit 2 ~a&b, bit 3 the old dst: AND 1, OR 7, XOR 6,
// ANDNOT 2, ZERO 0, COPY and EXPAND 3, THRESH 9) and the byte offsets in
// the tile of dst, a and b.
__device__ __forceinline__ int4 plan_row(int4 ins, int C) {
  const unsigned int tt = (0x93302671u >> (4 * ins.x)) & 0xFu;
  return make_int4((int)tt, ins.y * C * 4, ins.z * C * 4, ins.w * C * 4);
}

// The truth table applied word by word; m1, m2, m3 are all ones or all
// zeros from its bits 0-2, and d is zero unless bit 3 is set.
__device__ __forceinline__ uint32_t w_table(uint32_t a, uint32_t b,
                                            uint32_t d, uint32_t m1,
                                            uint32_t m2, uint32_t m3) {
  return (a & ((b & m1) | (~b & m2))) | (~a & b & m3) | d;
}
__device__ __forceinline__ uint4 v_table(uint4 a, uint4 b, uint4 d,
                                         uint32_t m1, uint32_t m2,
                                         uint32_t m3) {
  return make_uint4(w_table(a.x, b.x, d.x, m1, m2, m3),
                    w_table(a.y, b.y, d.y, m1, m2, m3),
                    w_table(a.z, b.z, d.z, m1, m2, m3),
                    w_table(a.w, b.w, d.w, m1, m2, m3));
}
__device__ __forceinline__ uint2 v_table(uint2 a, uint2 b, uint2 d,
                                         uint32_t m1, uint32_t m2,
                                         uint32_t m3) {
  return make_uint2(w_table(a.x, b.x, d.x, m1, m2, m3),
                    w_table(a.y, b.y, d.y, m1, m2, m3));
}
__device__ __forceinline__ uint32_t v_table(uint32_t a, uint32_t b,
                                            uint32_t d, uint32_t m1,
                                            uint32_t m2, uint32_t m3) {
  return w_table(a, b, d, m1, m2, m3);
}

// Bytes staged ahead of the tile (a multiple of 16, so the tile stays
// 16-byte aligned): slot descriptors, plan rows, count-lane and row-lane
// indexes, each up to its cap.
__host__ __device__ __forceinline__ int staged_bytes(int n_slots,
                                                     int n_instrs,
                                                     int n_count, int n_row) {
  const int sd = n_slots < SLOT_CAP ? n_slots : SLOT_CAP;
  const int pl = n_instrs < PLAN_CAP ? n_instrs : PLAN_CAP;
  const int cl = n_count < LANE_CAP ? n_count : LANE_CAP;
  const int rl = n_row < LANE_CAP ? n_row : LANE_CAP;
  return ((sd + pl) * 16 + (cl + rl) * 4 + 15) / 16 * 16;
}

// V is uint4, uint2 or uint32_t: VW = sizeof(V)/4 words a thread of each
// register. blockDim.x == C / VW; the tile is [n_regs][C] words.
template <typename V>
__global__ void __launch_bounds__(MAX_THREADS)
mega_tile_kernel(const SlotDesc* __restrict__ slots, int n_slots,
                 const int4* __restrict__ instrs, int n_instrs,
                 const int* __restrict__ out_count, int n_count,
                 const int* __restrict__ out_row, int n_row,
                 int n_regs, int w_mega, int n, int C,
                 unsigned int* __restrict__ counts, V* __restrict__ rows) {
  constexpr int VW = sizeof(V) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = C / VW;
  const int n_sd = min(n_slots, SLOT_CAP);
  const int n_pl = min(n_instrs, PLAN_CAP);
  const int n_cl = min(n_count, LANE_CAP);
  const int n_rl = min(n_row, LANE_CAP);
  SlotDesc* const s_slot = reinterpret_cast<SlotDesc*>(smem);
  int4* const s_plan = reinterpret_cast<int4*>(s_slot + n_sd);
  int* const s_cidx = reinterpret_cast<int*>(s_plan + n_pl);
  int* const s_ridx = s_cidx + n_cl;
  V* const mine = reinterpret_cast<V*>(
      smem + staged_bytes(n_slots, n_instrs, n_count, n_row)) + threadIdx.x;
  unsigned char* const mine_bytes = reinterpret_cast<unsigned char*>(mine);
  for (int k = threadIdx.x; k < n_sd; k += blockDim.x) s_slot[k] = slots[k];
  for (int k = threadIdx.x; k < n_pl; k += blockDim.x) {
    s_plan[k] = plan_row(instrs[k], C);
  }
  for (int k = threadIdx.x; k < n_cl; k += blockDim.x) {
    s_cidx[k] = out_count[k];
  }
  for (int k = threadIdx.x; k < n_rl; k += blockDim.x) s_ridx[k] = out_row[k];
  __syncthreads();

  unsigned int acc[REG_LANES];  // this thread's part of count lanes 0..31
#pragma unroll
  for (int k = 0; k < REG_LANES; ++k) acc[k] = 0u;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n + C - 1) / C;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int j = t * C + threadIdx.x * VW;  // first word column owned
    const bool active = j < n;
    const int s = active ? j / w_mega : 0;
    const int w = active ? j - s * w_mega : 0;

    // 1. gather the slot registers, zero the scratch ones.
    for (int r = 0; r < n_slots; ++r) {
      V* dst = mine + (size_t)r * cols;
      const SlotDesc d = r < SLOT_CAP ? s_slot[r] : slots[r];
      const int valid = active ? min(max(d.valid - w, 0), VW) : 0;
      if (valid == 0) {
        *dst = v_zero<V>();
        continue;
      }
      const uint32_t* row = reinterpret_cast<const uint32_t*>(d.base);
      const uint32_t* src = row + (long long)s * d.w_bank + w;
      if (VW == 1 || (d.w_bank % VW == 0 && d.base % (VW * 4) == 0)) {
        cp_async<VW * 4>(dst, src, valid * 4);
      } else {
        uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
        for (int k = 0; k < VW; ++k) {
          cp_async<4>(dw + k, k < valid ? src + k : row,
                      k < valid ? 4 : 0);
        }
      }
    }
    for (int r = n_slots; r < n_regs; ++r) {
      mine[(size_t)r * cols] = v_zero<V>();
    }
    cp_async_wait_all();

    // 2. the plan, in order, over this thread's words.
    for (int c0 = 0; c0 < n_instrs; c0 += PLAN_CAP) {
      const int m = min(PLAN_CAP, n_instrs - c0);
      if (n_instrs > PLAN_CAP) {
        __syncthreads();  // every thread is done with the last chunk
        for (int k = threadIdx.x; k < m; k += blockDim.x) {
          s_plan[k] = plan_row(instrs[c0 + k], C);
        }
        __syncthreads();
      }
      for (int i = 0; i < m; ++i) {
        const int4 ins = s_plan[i];
        const unsigned int tt = (unsigned int)ins.x;
        V* dst = reinterpret_cast<V*>(mine_bytes + ins.y);
        const V a = *reinterpret_cast<const V*>(mine_bytes + ins.z);
        const V b = *reinterpret_cast<const V*>(mine_bytes + ins.w);
        V d = v_zero<V>();
        if (tt & 8u) d = *dst;
        *dst = v_table(a, b, d, 0u - (tt & 1u), 0u - ((tt >> 1) & 1u),
                       0u - ((tt >> 2) & 1u));
      }
    }

    // 3. row lanes out, count lanes into registers (or atomics).
    if (active) {
      for (int k = 0; k < n_row; ++k) {
        const int reg = k < LANE_CAP ? s_ridx[k] : __ldg(out_row + k);
        rows[((long long)k * n + j) / VW] = mine[(size_t)reg * cols];
      }
#pragma unroll
      for (int k = 0; k < REG_LANES; ++k) {
        if (k < n_count) acc[k] += v_popc(mine[(size_t)s_cidx[k] * cols]);
      }
    }
    for (int k = REG_LANES; k < n_count; ++k) {
      const int reg = k < LANE_CAP ? s_cidx[k] : __ldg(out_count + k);
      unsigned int v = active ? v_popc(mine[(size_t)reg * cols]) : 0u;
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && v) atomicAdd(&counts[k], v);
    }
  }
#pragma unroll
  for (int k = 0; k < REG_LANES; ++k) {
    if (k < n_count) {
      const unsigned int v = __reduce_add_sync(0xffffffffu, acc[k]);
      if (lane == 0 && v) atomicAdd(&counts[k], v);
    }
  }
}

bool aligned(const void* p, unsigned int to) {
  return (reinterpret_cast<uintptr_t>(p) % to) == 0;
}

template <typename V>
int launch(const SlotDesc* slots, int n_slots, const int4* instrs,
           int n_instrs, const int* out_count, int n_count,
           const int* out_row, int n_row, int n_regs, int w_mega, int n,
           int C, unsigned int* counts, void* rows, long long* info,
           cudaStream_t stream) {
  constexpr int VW = sizeof(V) / 4;
  const int threads = C / VW;
  const size_t smem = (size_t)n_regs * C * 4 +
                      staged_bytes(n_slots, n_instrs, n_count, n_row);
  cudaError_t err = cudaFuncSetAttribute(
      mega_tile_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_tile_kernel<V>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + C - 1) / C;
  const int blocks = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  if (info) {
    info[0] = C;
    info[1] = (long long)smem;
    info[2] = blocks;
    info[3] = threads;
  }
  mega_tile_kernel<V><<<blocks, threads, smem, stream>>>(
      slots, n_slots, instrs, n_instrs, out_count, n_count, out_row, n_row,
      n_regs, w_mega, n, C, counts, static_cast<V*>(rows));
  return (int)cudaGetLastError();
}

}  // namespace

// slots: n_slots 16-byte descriptors (SlotDesc); instrs: the first n_instrs
// rows of the int32 [P, 4] plan; out_count [n_count] and out_row [n_row]
// register indexes; counts: u32 [n_count], zeroed by the caller; rows:
// int32 [n_row, n_shards, w_mega]. All on the card. info, when not null,
// is a host array of four long longs that receives the tile's columns C,
// its dynamic shared memory in bytes, the grid's blocks and the block's
// threads. Returns the cudaError_t of the launch (0 on success).
extern "C" int mega_interpret(const void* slots, long long n_slots,
                              const void* instrs, long long n_instrs,
                              const void* out_count, long long n_count,
                              const void* out_row, long long n_row,
                              long long n_regs, long long n_shards,
                              long long w_mega, void* counts, void* rows,
                              void* info, void* stream) {
  if (n_regs < 1 || n_slots < 0 || n_slots > n_regs || w_mega < 1 ||
      n_shards < 0 || n_instrs < 0 || n_count < 0 || n_row < 0 ||
      n_instrs > 0x7fffffffLL || n_count > 0x7fffffffLL ||
      n_row > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long n = n_shards * w_mega;
  if (n > (1LL << 27) - 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || (n_count == 0 && n_row == 0)) return 0;
  if (!aligned(slots, 16) || !aligned(instrs, 16))
    return (int)cudaErrorMisalignedAddress;
  int vec = (w_mega % 4 == 0) ? 4 : (w_mega % 2 == 0) ? 2 : 1;
  while (vec > 1 && !aligned(rows, 4u * vec)) vec /= 2;
  const long long staged = staged_bytes((int)n_slots, (int)n_instrs,
                                        (int)n_count, (int)n_row);
  int C = MAX_THREADS * vec < MAX_TILE_WORDS ? MAX_THREADS * vec
                                             : MAX_TILE_WORDS;
  while (C > MIN_TILE_WORDS && n_regs * C * 4 + staged > TWO_BLOCK_SMEM)
    C /= 2;
  if (n_regs * C * 4 + staged > MAX_BLOCK_SMEM)
    return (int)cudaErrorInvalidValue;
  while (vec > 1 && C / vec < 128) vec /= 2;  // four warps where C allows
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SlotDesc* sd = static_cast<const SlotDesc*>(slots);
  const int4* ins = static_cast<const int4*>(instrs);
  const int* oc = static_cast<const int*>(out_count);
  const int* orow = static_cast<const int*>(out_row);
  unsigned int* cnt = static_cast<unsigned int*>(counts);
  long long* inf = static_cast<long long*>(info);
  if (vec == 4)
    return launch<uint4>(sd, (int)n_slots, ins, (int)n_instrs, oc,
                         (int)n_count, orow, (int)n_row, (int)n_regs,
                         (int)w_mega, (int)n, C, cnt, rows, inf, s);
  if (vec == 2)
    return launch<uint2>(sd, (int)n_slots, ins, (int)n_instrs, oc,
                         (int)n_count, orow, (int)n_row, (int)n_regs,
                         (int)w_mega, (int)n, C, cnt, rows, inf, s);
  return launch<uint32_t>(sd, (int)n_slots, ins, (int)n_instrs, oc,
                          (int)n_count, orow, (int)n_row, (int)n_regs,
                          (int)w_mega, (int)n, C, cnt, rows, inf, s);
}
