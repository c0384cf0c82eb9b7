// Rotation-family Count-Sketch kernels for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package
// (commefficient_tpu/sketch/pallas_kernels.py):
//
//   sketch_accumulate  <- _accumulate_kernel (entered via _accumulate_call /
//                         sketch_vec): [d] vector -> [r, c] table.
//   sketch_query       <- _query_kernel (entered via _query_call / query_all):
//                         [r, c] table -> [d] lower-median estimates.
//   sketch_accumulate_tree <- _accumulate_kernel (pallas_kernels.py:135)
//                         applied to a tree of leaves: the layerwise sketch
//                         path, where the JAX package folds one leaf at a
//                         time in pure JAX (sketch/layerwise.py:136-163,
//                         _accumulate_leaf_rotation) and the port folds a
//                         whole tree in one launch of accumulate_tree_tiles
//                         (its note is above the kernel).
//
// Hash family. Coordinate i (slab s = i / c, position p = i mod c) of row j
// lands in bucket (p + shift[j, s]) mod c with sign
// fmix32(uint32(i) ^ ks[j]) bit 16 (set -> -1). The per-(row, slab) shifts
// (int32 [r, S]) and sign keys (uint32 [r]) are tiny and come from the
// host-side hashing module; signs are recomputed here, so no [r, d] hash
// tensor exists.
//
// Bound. Both kernels are memory-bound: their minimum traffic is the [d]
// vector once plus the [r, c] table once. At the ResNet-9 slice's shapes
// (d = 6,573,130, c = 524,288, r = 5) that is 26.3 MB + 10.5 MB = 36.8 MB,
// about 11 us at 3.35 TB/s; the arithmetic (one fmix32 and one add per
// (row, coordinate)) is below the card's integer and float rates.
//
// Design. The TPU kernel streams each slab once while the whole table stays
// resident in VMEM; a Hopper block cannot hold the table, and blocks run in
// no order. So a block owns a tile of kTile consecutive buckets (accumulate)
// or coordinates (query) and walks its slabs through a ring of shared-memory
// slots; each slot holds the windows of the other tensor that the rotation
// maps onto the tile for one slab. A window is contiguous modulo c, so it
// is at most two pieces, split where it wraps at the end of the slab (or
// table row).
//
// A block is one producer warp and kConsumerWarps consumer warps, and the
// ring's slots hand over through mbarriers: full[st] completes when slot st
// is staged, empty[st] when every consumer warp is done with it. The
// producer stages a window at an offset e in [0, 4) of its slot, the
// element offset of its first global address within 16 bytes, so global and
// shared addresses agree modulo 16: lane 0 copies the 16-byte chunks that
// lie wholly inside a piece with one TMA 1-D bulk copy (cp.async.bulk,
// counted on full[st]), and the lanes copy the ragged ends (at most 3
// elements each) with 4-byte cp.async, which full[st] also waits for. A
// piece whose alignment disagrees with e (only when c is not a multiple of
// 4) goes by 4-byte copies alone. Nothing outside a piece is read, so no
// copy reaches past the end of v or of the table. Consumer thread t owns
// the items t, t + kConsumers, ... of the tile: its shared-memory reads are
// conflict-free and need no shuffle by e, and it never waits for staging
// work, only for data.
//
// - accumulate: grid (ceil(c / kTile), r); a block owns buckets
//   [b0, b0 + kTile) of row j and walks every slab in order, s = 0..S-1,
//   kAccStages slabs in flight. Slab s's window is
//   v[s*c + (b0 - shift[j,s]) mod c ...]. Each thread adds sign * v in slab
//   order to its sums in registers, starting from +0: each bucket is exactly
//   the plain version's left fold, and skipping the padded coordinates
//   (i >= d) is exact because the fold starts from +0, so the result equals
//   the plain PyTorch version bitwise. No atomics. The sums leave through
//   shared memory, so that each thread writes four consecutive buckets with
//   one 16-byte store where the row's offset allows.
// - query: grid (ceil(c / kTile), gy); a block owns coordinates
//   [p0, p0 + kTile) of the slabs blockIdx.y, blockIdx.y + gy, ... (no
//   per-thread division), where gy makes about kBlocksPerSm blocks per SM.
//   A slot holds the r windows table[j, (p0 + shift[j,s]) mod c ...]
//   (kQueryStages * r * (tile + 4) * 4 bytes of dynamic shared memory,
//   which the launch requests: above 48 KB it is refused otherwise; above 8
//   rows the query's tile is half of kTile, so that two slots fit). Each
//   thread signs the r values of each of its coordinates and takes the
//   lower median, element (r-1)/2, through an odd-even transposition
//   network in registers, templated on r. The median selects one of its
//   inputs, so it equals the plain sort-based version bitwise (up to the
//   sign of zero). A warp's stores cover 128 consecutive bytes, whole lines.
//
// The floor that remains. Every element of v is gathered r times, once per
// row's bucket tile, and every table element S times, once per slab: about
// r * d * 4 = 131 MB of reads through L2 at the slice's shapes, for either
// kernel. v (26.3 MB) and the table (10.5 MB) fit in the 50 MB L2, so after
// the first touch these reads come from L2, not HBM; the bound stays the
// HBM bound of 36.8 MB. Beside the copies, each (row, coordinate) costs a
// shared-memory load, the sign hash and an add (or its share of the
// median), and the hash's integer operations run on the SM's integer pipe,
// a quarter of its lanes. PERF.md gives the measured split.
//
// Offsets into v, the table and the output are int64; positions within a
// slab or row are 32-bit (c <= 2^31 - 1). Every entry returns
// cudaGetLastError() (or a refused attribute) after its launch; the launches
// are asynchronous on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The tile's shape and the rings' depths are the measured choice (PERF.md).
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;   // threads that fold or take medians
constexpr int kThreads = kConsumers + 32;         // and one producer warp, the last
constexpr int kPerThread = 16;                    // items per consumer thread
constexpr int kTile = kConsumers * kPerThread;    // buckets or coordinates per block
constexpr int kAccStages = 4;                     // accumulate's ring: slabs in flight
constexpr int kQueryStages = 2;                   // query's ring (a slot holds r windows)
constexpr int kWindow = kTile + 4;                // floats per window: kTile at an offset < 4
constexpr int kMaxRows = 16;
constexpr int kMaxSmem = 232448;                  // shared memory a block may have
constexpr int kBlocksPerSm = 2;                   // the query's grid aims at this many
constexpr int64_t kMaxGridY = 65535;
static_assert(kAccStages >= 2 && kQueryStages >= 2, "a ring needs at least two slots");

// A row's sign key folded for sign_mask: key ^ (key >> 16).
__device__ __forceinline__ uint32_t fold_key(uint32_t key) { return key ^ (key >> 16); }

// Bit 16 of fmix32(i ^ key), moved to bit 31: the sign of coordinate i in
// the row keyed `key` (set -> -1), given kf = fold_key(key). fmix32 starts
// with x = i ^ key, x ^= x >> 16, which is i ^ (i >> 16) ^ kf, one 3-way
// xor; its last step, x ^= x >> 16, leaves bit 16 as it is, so it is left
// out. The integer pipe, which these operations share, bounds the kernels'
// arithmetic.
__device__ __forceinline__ uint32_t sign_mask(uint32_t i, uint32_t kf) {
  uint32_t x = i ^ (i >> 16) ^ kf;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return (x << 15) & 0x80000000u;
}

// x * (+-1) by the sign bit: exact, as the plain version's multiply is.
__device__ __forceinline__ float apply_sign(float x, uint32_t mask) {
  return __uint_as_float(__float_as_uint(x) ^ mask);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint32_t minu(uint32_t a, uint32_t b) { return a < b ? a : b; }

// Element offset of p within its 16-byte chunk.
__device__ __forceinline__ int offset16(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// `bar` also waits for this thread's earlier cp.async copies.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Shared memory that generic loads read is about to be written by the
// asynchronous (TMA) proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA 1-D bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned), completing on `bar`, which first expects the bytes.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The producer warp copies window positions [w0, w1) of one piece into
// `win` (16-byte aligned), position w at win[w + e]; `src` is the global
// address of position w0. Lane 0 bulk-copies the whole 16-byte chunks; the
// lanes copy the rest with 4-byte cp.async.
__device__ __forceinline__ void stage_piece(float* win, int e, int w0, int w1, const float* src,
                                            uint64_t* bar, int lane) {
  if (w0 >= w1) return;
  int head_end = w1, tail_begin = w1;  // 4-byte copies: [w0, head_end), [tail_begin, w1)
  const int qa = (w0 + e + 3) >> 2, qb = (w1 + e) >> 2;  // whole chunks [qa, qb)
  if (offset16(src) == ((w0 + e) & 3) && qa < qb) {
    head_end = 4 * qa - e;
    tail_begin = 4 * qb - e;
    if (lane == 0)
      bulk_copy(win + 4 * qa, src + (head_end - w0), 16u * static_cast<uint32_t>(qb - qa), bar);
  }
  for (int m = w0 + lane; m < head_end; m += 32) cp_async4(win + m + e, src + (m - w0));
  for (int m = tail_begin + lane; m < w1; m += 32) cp_async4(win + m + e, src + (m - w0));
}

// The producer warp stages the rotated window of `len` positions starting
// at `start` of a slab or row `base` of length c: position w holds
// base[(start + w) mod c]. Only the positions whose element index
// (start + w) mod c is below `lim` are copied (the rest lie past d).
__device__ __forceinline__ void stage_window(float* win, int e, const float* base, uint32_t c,
                                             uint32_t lim, uint32_t start, int len,
                                             uint64_t* bar, int lane) {
  const uint32_t la = minu(len, c - start);
  stage_piece(win, e, 0, lim > start ? static_cast<int>(minu(la, lim - start)) : 0,
              base + start, bar, lane);
  stage_piece(win, e, static_cast<int>(la), static_cast<int>(minu(len, la + lim)), base, bar,
              lane);
}

// The ring's barriers: full[st] completes when slot st is staged (its
// producer's arrive, the bulk bytes and the lanes' 4-byte copies); empty[st]
// when every consumer warp is done reading it.
template <int Stages>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < Stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Producer, before staging its n-th slab into slot n % Stages: wait until
// the consumers released the slot's previous slab.
template <int Stages>
__device__ __forceinline__ void acquire_slot(uint64_t* empty, int64_t n, int st, int lane) {
  if (n >= Stages) mbar_wait(&empty[st], static_cast<uint32_t>((n / Stages - 1) & 1));
  if (lane == 0) fence_proxy_async();
}

// Producer, after staging: the lanes' 4-byte copies join the barrier, then
// lane 0's arrive (after the bulk copies' expect_tx) can complete it.
__device__ __forceinline__ void publish_slot(uint64_t* full, int st, int lane) {
  cp_async_arrive(&full[st]);
  __syncwarp();
  if (lane == 0) mbar_arrive(&full[st]);
}

// Consumer warp, after its last read of slot st.
__device__ __forceinline__ void release_slot(uint64_t* empty, int st, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[st]);
}

__global__ void __launch_bounds__(kThreads)
accumulate_tiles(const float* __restrict__ v, const int32_t* __restrict__ shifts,
                 const uint32_t* __restrict__ ks, float* __restrict__ out,
                 int64_t d, int64_t c64, int64_t num_slabs) {
  extern __shared__ __align__(16) float windows[];  // [kAccStages][kWindow]
  __shared__ __align__(8) uint64_t full[kAccStages];
  __shared__ __align__(8) uint64_t empty[kAccStages];
  __shared__ uint32_t start_of[kAccStages];
  __shared__ int e_of[kAccStages];
  const uint32_t c = static_cast<uint32_t>(c64);
  const int j = blockIdx.y;
  const uint32_t b0 = blockIdx.x * static_cast<uint32_t>(kTile);
  const int len = static_cast<int>(minu(kTile, c - b0));
  const int32_t* row_shifts = shifts + j * num_slabs;
  const int t = threadIdx.x, lane = t & 31;
  // producer lane m holds the shift of slab 32q + m while it stages slabs
  // 32q .. 32q + 31: one load latency per 32 slabs, the first hidden here
  uint32_t lane_shift =
      t >= kConsumers && lane < num_slabs ? static_cast<uint32_t>(row_shifts[lane]) : 0u;
  init_ring<kAccStages>(full, empty);

  if (t >= kConsumers) {
    // producer: slab s's window is the slab positions whose coordinates land
    // in buckets b0, b0 + 1, ...; it starts at (b0 - shift) mod c
    for (int64_t s = 0; s < num_slabs; ++s) {
      if ((s & 31) == 0 && s > 0)
        lane_shift = s + lane < num_slabs ? static_cast<uint32_t>(row_shifts[s + lane]) : 0u;
      const uint32_t shift = __shfl_sync(0xFFFFFFFFu, lane_shift, static_cast<int>(s & 31));
      const int st = static_cast<int>(s % kAccStages);
      acquire_slot<kAccStages>(empty, s, st, lane);
      const uint32_t start = b0 >= shift ? b0 - shift : b0 + (c - shift);
      const float* slab = v + s * c64;
      const int e = offset16(slab + start);
      if (lane == 0) {
        start_of[st] = start;
        e_of[st] = e;
      }
      const uint32_t lim = static_cast<uint32_t>(min64(c64, d - s * c64));
      stage_window(windows + st * kWindow, e, slab, c, lim, start, len, &full[st], lane);
      publish_slot(full, st, lane);
    }
  }

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.0f;
  if (t < kConsumers) {
    const uint32_t key = fold_key(ks[j]);
    for (int64_t s = 0; s < num_slabs; ++s) {
      const int st = static_cast<int>(s % kAccStages);
      mbar_wait(&full[st], static_cast<uint32_t>((s / kAccStages) & 1));
      const uint32_t start = start_of[st];
      const uint32_t lim = static_cast<uint32_t>(min64(c64, d - s * c64));
      const uint32_t slab_base = static_cast<uint32_t>(s * c64);  // uint32(i), as hashed
      const float* win = windows + st * kWindow + e_of[st];
      if (len == kTile && start + kTile <= lim) {
        // whole tile, no wrap, no padded coordinate: position w is coordinate i0 + w
        const uint32_t i0 = slab_base + start;
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int w = t + k * kConsumers;
          acc[k] += apply_sign(win[w], sign_mask(i0 + w, key));
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int w = t + k * kConsumers;
          uint32_t p = start + w;
          if (p >= c) p -= c;
          if (w < len && p < lim) acc[k] += apply_sign(win[w], sign_mask(slab_base + p, key));
        }
      }
      release_slot(empty, st, lane);
    }
  }

  // the sums leave through shared memory, so that each thread stores four
  // consecutive buckets at once; every slot's copies were consumed above
  float* row_out = out + j * c64 + b0;
  __syncthreads();
  float* sums = windows;
  if (t < kConsumers)
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) sums[t + k * kConsumers] = acc[k];
  __syncthreads();
  const bool vec = offset16(row_out) == 0;
  for (int w = 4 * t; w < len; w += 4 * kThreads) {
    if (vec && w + 4 <= len) {
      *reinterpret_cast<float4*>(row_out + w) = *reinterpret_cast<const float4*>(sums + w);
    } else {
      for (int k = w; k < w + 4 && k < len; ++k) row_out[k] = sums[k];
    }
  }
}

// The window of a tile starting at bucket b0 in a slab of shift `shift`
// starts at slab position (b0 - shift) mod c.
__device__ __forceinline__ uint32_t window_start(uint32_t b0, uint32_t shift, uint32_t c) {
  return b0 >= shift ? b0 - shift : b0 + (c - shift);
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// One launch's share of a tree: leaf m holds the coordinates [begin[m],
// end[m]) of the raveled [d] vector at ptr[m], a separate allocation or a
// view at any 4-byte alignment; the ranges ascend and do not overlap, and
// gaps between them add nothing. The struct is a __grid_constant__
// parameter, passed by value: no copy to the device, no wait for the host.
// At 24 bytes a leaf, kTreeLeaves is what fits, beside the kernel's other
// parameters, in the classic 4 KB of a kernel's parameters; a larger tree
// takes ceil(L / kTreeLeaves) launches, each continuing the fold in place.
constexpr int kTreeLeaves = 160;
constexpr int kTreeBlocksPerSm = 4;  // the tree's grid tries this many blocks an SM first
constexpr int kTreeProducers = 4;    // producer warps a block: window n is warp n % this
constexpr int kTreeThreads = kConsumers + 32 * kTreeProducers;

struct TreeLeaves {
  const float* ptr[kTreeLeaves];
  int64_t begin[kTreeLeaves];
  int64_t end[kTreeLeaves];
  int32_t count;
};
static_assert(sizeof(TreeLeaves) + 64 <= 4096,
              "the tree and the kernel's other parameters must fit in 4 KB");

// The first of the leaves [m, last) whose range ends after coordinate g
// (last if none): a binary search, since the ranges ascend.
__device__ __forceinline__ int leaf_after(const TreeLeaves& tree, int m, int last, int64_t g) {
  while (m < last) {
    const int mid = (m + last) >> 1;
    if (tree.end[mid] <= g) {
      m = mid + 1;
    } else {
      last = mid;
    }
  }
  return m;
}

// The producer warp sets window positions [w0, w1) to +0.
__device__ __forceinline__ void zero_positions(float* win, int e, int w0, int w1, int lane) {
  for (int w = w0 + lane; w < w1; w += 32) win[w + e] = 0.0f;
}

// The producer warp stages the coordinates [ga, gb) of the raveled vector at
// window positions w0, w0 + 1, ..., from the leaves m, m + 1, ... (m the
// first whose range ends after ga; none at or past `last` reaches below gb).
// Each leaf's share is copied from that leaf (stage_piece), so no copy reads
// outside a leaf; the positions between two leaves are set to +0, which
// adds an exact +-0 to a sum, as the plain fold's zero padding does.
__device__ __forceinline__ void stage_tree_piece(float* win, int e, int w0, int64_t ga,
                                                 int64_t gb, const TreeLeaves& tree, int m,
                                                 int last, uint64_t* bar, int lane) {
  int64_t at = ga;
  for (; m < last && tree.begin[m] < gb; ++m) {
    const int64_t x0 = max64(ga, tree.begin[m]), x1 = min64(gb, tree.end[m]);
    zero_positions(win, e, w0 + static_cast<int>(at - ga), w0 + static_cast<int>(x0 - ga), lane);
    stage_piece(win, e, w0 + static_cast<int>(x0 - ga), w0 + static_cast<int>(x1 - ga),
                tree.ptr[m] + (x0 - tree.begin[m]), bar, lane);
    at = x1;
  }
  zero_positions(win, e, w0 + static_cast<int>(at - ga), w0 + static_cast<int>(gb - ga), lane);
}

// Tile q of the r * ceil(c / kTile) (row, bucket tile) pairs, row-major: the
// tile's row j and first bucket b0, and its length (the last tile of a row
// may be short). `next` steps to tile q + 1.
struct TileCursor {
  int j;
  uint32_t bt;
  __device__ __forceinline__ uint32_t b0() const { return bt * static_cast<uint32_t>(kTile); }
  __device__ __forceinline__ int len(uint32_t c) const {
    return static_cast<int>(minu(kTile, c - b0()));
  }
  __device__ __forceinline__ void next(uint32_t tiles_a_row) {
    if (++bt == tiles_a_row) {
      bt = 0;
      ++j;
    }
  }
};

// The layerwise fold of a whole tree, in one persistent launch.
//
// Work. The table, fresh (+0) or running (in place), plus each leaf's
// coordinates signed and rotated into it: the same left fold per bucket as
// accumulate_tiles, over the slabs the tree's leaves touch. Bound: the
// leaves read once and the table written once (fresh: 4d + 4rc bytes; in
// place: 4d + 8rc), at 3.35 TB/s; 36.8 MB and 11 us for a fresh table at
// the ResNet-9 slice's shapes, 361.8 MB and 108 us at GPT-2's (d =
// 85,453,056, c = 1,000,000, r = 5).
//
// Design. The TPU kernel keeps the whole [r, c] table resident in VMEM while
// the slabs stream, so each slab of v is read from HBM once for all r rows.
// Here the table is spread over the SMs instead: the grid is one wave of
// blocks (kTreeBlocksPerSm an SM, fewer if their sums do not fit), and
// each block owns a contiguous run of the r * ceil(c / kTile) (row, bucket
// tile) pairs, split evenly over the blocks, whose sums stay in its shared
// memory (kTile floats a pair, beside the ring) from the first slab to the
// last. Every block walks the slabs in order, s = s_lo .. s_hi, and within
// each slab stages and folds the window of each of its tiles through the
// ring of accumulate_tiles (TMA bulk copies and 4-byte cp.async,
// mbarriers). kTreeProducers producer warps take turns, window by window:
// one warp's serial work a window (its barriers, the copies' issue, the
// leaves' bounds) took about 1 us on the H100 and bounded the walk with
// one producer a block (PERF.md gives the measured split). All blocks
// start together and do the same work a slab, so they stay within a few
// slabs of one another: a slab (4 MB at GPT-2) is read from HBM about
// once, by whichever block touches it first, and the other r - 1 rows'
// reads of it hit the 50 MB L2. accumulate_tiles, whose (tile, row) blocks
// run in waves that each stream all of v, reads v from HBM up to r times
// once v outgrows the L2. The r-fold gather itself (each coordinate staged
// once a row, r * 4d bytes through L2 and shared memory) remains: a row's
// window lands at its own shift, so no block can share a slab's copy
// between rows. Sums that do not fit in one wave (very large r * c) make
// the grid longer than one wave: still correct, with the later waves
// reading v from HBM again. Every launch reads (in place) and writes the
// whole table, so a launch for a small leaf costs the table's bytes.
//
// The leaves. A window is contiguous modulo c, so it is at most two pieces
// of one slab; the producer cuts each piece again at the leaves' bounds
// (the first leaf by a binary search among the leaves that reach into the
// slab, a range its cursor moves forward slab by slab) and stages each
// leaf's share from that leaf's own memory. The slot's offset e aligns the
// window's first covered coordinate with its leaf's 16-byte offset; a leaf
// whose alignment disagrees with e goes by 4-byte copies. Positions outside
// [begin of the first leaf, end of the last) of this launch are not staged
// and the consumers skip them; positions in a gap between two leaves are
// set to +0.
//
// The fold. Each consumer thread owns the same positions of every tile
// (t, t + kConsumers, ...), starts their sums from +0 (fresh) or from the
// table (in place), and for each window takes its sums into registers, adds
// the slab's terms and puts them back: each bucket gets its slab terms in
// slab order, each exactly once. No other thread touches those sums until
// the walk ends, so no atomics and no barrier. The table's bucket
// therefore gets the plain per-leaf fold's sum after the whole tree, and,
// for a fresh table and a tree that covers [0, d), sketch_accumulate's sum
// of the concatenated vector, bitwise (up to the sign of zero). At the end
// each tile is written once, with 16-byte stores where the row's offset
// allows.
__global__ void __launch_bounds__(kTreeThreads)
accumulate_tree_tiles(const __grid_constant__ TreeLeaves tree, float* __restrict__ table,
                      const int32_t* __restrict__ shifts, const uint32_t* __restrict__ ks,
                      int64_t c64, int32_t r, int64_t num_slabs, int32_t fresh) {
  extern __shared__ __align__(16) float smem[];
  float* windows = smem;                      // [kAccStages][kWindow]
  float* sums = smem + kAccStages * kWindow;  // [pairs of this block][kTile]
  __shared__ __align__(8) uint64_t full[kAccStages];
  __shared__ __align__(8) uint64_t empty[kAccStages];
  __shared__ uint32_t start_of[kAccStages];
  __shared__ int e_of[kAccStages];
  __shared__ uint32_t key_of[kMaxRows];
  const uint32_t c = static_cast<uint32_t>(c64);
  const uint32_t tiles_a_row = static_cast<uint32_t>((c64 + kTile - 1) / kTile);
  const int64_t tiles = int64_t{tiles_a_row} * r;
  const int64_t q0 = tiles * blockIdx.x / gridDim.x;
  const int nt = static_cast<int>(tiles * (blockIdx.x + 1) / gridDim.x - q0);
  const TileCursor first{static_cast<int>(q0 / tiles_a_row),
                         static_cast<uint32_t>(q0 % tiles_a_row)};
  const int rows = static_cast<int>((q0 + nt - 1) / tiles_a_row) - first.j + 1;
  const int64_t lo_g = tree.begin[0], hi_g = tree.end[tree.count - 1];
  const int64_t s_lo = lo_g / c64, s_hi = (hi_g - 1) / c64;
  const int t = threadIdx.x, lane = t & 31;
  if (t < rows) key_of[t] = fold_key(ks[first.j + t]);
  init_ring<kAccStages>(full, empty);

  if (t >= kConsumers) {
    // producer warp pw stages windows pw, pw + kTreeProducers, ...; lane m
    // < rows holds the shift of row first.j + m in the current slab, and
    // loads the next slab's a slab ahead
    const int pw = (t - kConsumers) >> 5;
    const int32_t* lane_shifts = shifts + (first.j + (lane < rows ? lane : 0)) * num_slabs;
    uint32_t shift_now = lane < rows ? static_cast<uint32_t>(lane_shifts[s_lo]) : 0u;
    int lf = 0, ls = 0;  // the leaves [lf, ls) reach into slab s
    int64_t n = 0;
    for (int64_t s = s_lo; s <= s_hi; ++s) {
      const uint32_t shift_next =
          lane < rows && s < s_hi ? static_cast<uint32_t>(lane_shifts[s + 1]) : 0u;
      const int64_t base = s * c64;
      while (lf < tree.count && tree.end[lf] <= base) ++lf;
      while (ls < tree.count && tree.begin[ls] < base + c64) ++ls;
      // the slab positions [lo, hi) this launch covers
      const uint32_t lo = static_cast<uint32_t>(max64(lo_g - base, 0));
      const uint32_t hi = static_cast<uint32_t>(min64(hi_g - base, c64));
      TileCursor tile = first;
      for (int ti = 0; ti < nt; ++ti, ++n, tile.next(tiles_a_row)) {
        const uint32_t shift = __shfl_sync(0xFFFFFFFFu, shift_now, tile.j - first.j);
        if (n % kTreeProducers != pw) continue;
        const int st = static_cast<int>(n % kAccStages);
        acquire_slot<kAccStages>(empty, n, st, lane);
        const int len = tile.len(c);
        const uint32_t start = window_start(tile.b0(), shift, c);
        const uint32_t la = minu(len, c - start);  // positions before the wrap
        // covered: slab positions [a0, a1) of the first piece (window
        // position p - start), [lo, b1) of the wrapped one (la + p)
        const uint32_t a0 = start > lo ? start : lo, a1 = minu(start + la, hi);
        const uint32_t b1 = minu(len - la, hi);
        const bool has_a = a0 < a1, has_b = lo < b1;
        const int64_t at = base + (has_a ? a0 : lo);
        const int m = leaf_after(tree, lf, ls, at);
        // e aligns the first covered coordinate with its leaf's 16 bytes
        int e = 0;
        if ((has_a || has_b) && m < ls) {
          const int64_t x0 = max64(at, tree.begin[m]);
          const int64_t w = (has_a ? a0 - start : la + lo) + (x0 - at);
          e = static_cast<int>((offset16(tree.ptr[m]) + (x0 - tree.begin[m]) - w) & 3);
        }
        if (lane == 0) {
          start_of[st] = start;
          e_of[st] = e;
        }
        float* win = windows + st * kWindow;
        if (has_a)
          stage_tree_piece(win, e, static_cast<int>(a0 - start), base + a0, base + a1, tree, m,
                           ls, &full[st], lane);
        if (has_b)
          stage_tree_piece(win, e, static_cast<int>(la + lo), base + lo, base + b1, tree,
                           has_a ? leaf_after(tree, lf, ls, base + lo) : m, ls, &full[st], lane);
        publish_slot(full, st, lane);
      }
      shift_now = shift_next;
    }
  } else {
    // each consumer thread starts the sums of the positions it owns
    TileCursor tile = first;
    for (int ti = 0; ti < nt; ++ti, tile.next(tiles_a_row)) {
      const int len = tile.len(c);
      const float* row_in = table + tile.j * c64 + tile.b0();
      float* sum = sums + ti * kTile;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int w = t + k * kConsumers;
        sum[w] = fresh || w >= len ? 0.0f : row_in[w];
      }
    }
    int64_t n = 0;
    for (int64_t s = s_lo; s <= s_hi; ++s) {
      const int64_t base = s * c64;
      const uint32_t lo = static_cast<uint32_t>(max64(lo_g - base, 0));
      const uint32_t hi = static_cast<uint32_t>(min64(hi_g - base, c64));
      const uint32_t slab_base = static_cast<uint32_t>(base);  // uint32(i), as hashed
      tile = first;
      for (int ti = 0; ti < nt; ++ti, ++n, tile.next(tiles_a_row)) {
        const int st = static_cast<int>(n % kAccStages);
        mbar_wait(&full[st], static_cast<uint32_t>((n / kAccStages) & 1));
        const uint32_t start = start_of[st];
        const float* win = windows + st * kWindow + e_of[st];
        const uint32_t key = key_of[tile.j - first.j];
        const int len = tile.len(c);
        float* sum = sums + ti * kTile;
        // the terms go to registers first and the slot is released before
        // any sum is stored: the compiler cannot tell the sums from the
        // slot, and would otherwise wait out each store before the next load
        float acc[kPerThread];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) acc[k] = sum[t + k * kConsumers];
        if (len == kTile && start >= lo && start + kTile <= hi) {
          // whole tile covered, no wrap: position w is coordinate i0 + w
          const uint32_t i0 = slab_base + start;
#pragma unroll
          for (int k = 0; k < kPerThread; ++k) {
            const int w = t + k * kConsumers;
            acc[k] += apply_sign(win[w], sign_mask(i0 + w, key));
          }
        } else {
#pragma unroll
          for (int k = 0; k < kPerThread; ++k) {
            const int w = t + k * kConsumers;
            uint32_t p = start + w;
            if (p >= c) p -= c;
            if (w < len && p >= lo && p < hi)
              acc[k] += apply_sign(win[w], sign_mask(slab_base + p, key));
          }
        }
        release_slot(empty, st, lane);
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) sum[t + k * kConsumers] = acc[k];
      }
    }
  }

  // every tile leaves once, four consecutive buckets a store where the
  // row's offset allows, as accumulate_tiles writes its sums
  __syncthreads();
  TileCursor tile = first;
  for (int ti = 0; ti < nt; ++ti, tile.next(tiles_a_row)) {
    const int len = tile.len(c);
    float* row_out = table + tile.j * c64 + tile.b0();
    const float* sum = sums + ti * kTile;
    const bool vec = offset16(row_out) == 0;
    for (int w = 4 * t; w < len; w += 4 * kTreeThreads) {
      if (vec && w + 4 <= len) {
        *reinterpret_cast<float4*>(row_out + w) = *reinterpret_cast<const float4*>(sum + w);
      } else {
        for (int k = w; k < w + 4 && k < len; ++k) row_out[k] = sum[k];
      }
    }
  }
}

// The query's tile: a slot holds r windows, so above 8 rows the tile halves
// and two slots still fit in a block's shared memory.
template <int R>
struct QueryTile {
  static constexpr int kItems = R <= 8 ? kPerThread : kPerThread / 2;  // per consumer thread
  static constexpr int kSize = kConsumers * kItems;
  static constexpr int kSlotWindow = kSize + 4;
  static constexpr int kSmem = static_cast<int>(sizeof(float)) * kQueryStages * R * kSlotWindow;
  static_assert(kSmem + 4096 <= kMaxSmem, "the query's ring does not fit in shared memory");
};

template <int R>
__global__ void __launch_bounds__(kThreads)
query_tiles(const float* __restrict__ table, const int32_t* __restrict__ shifts,
            const uint32_t* __restrict__ ks, float* __restrict__ out,
            int64_t d, int64_t c64, int64_t num_slabs) {
  constexpr int kItems = QueryTile<R>::kItems;
  constexpr int kSize = QueryTile<R>::kSize;
  constexpr int kSlotWindow = QueryTile<R>::kSlotWindow;
  extern __shared__ __align__(16) float ring[];  // [kQueryStages][R][kSlotWindow]
  __shared__ __align__(8) uint64_t full[kQueryStages];
  __shared__ __align__(8) uint64_t empty[kQueryStages];
  __shared__ int e_of[kQueryStages][R];
  __shared__ uint32_t key_of[R];
  __shared__ uint32_t shift_of[R][32];  // the producer's shifts of 32 steps
  const uint32_t c = static_cast<uint32_t>(c64);
  const uint32_t p0 = blockIdx.x * static_cast<uint32_t>(kSize);
  const int t = threadIdx.x, lane = t & 31;
  if (t < R) key_of[t] = fold_key(ks[t]);
  init_ring<kQueryStages>(full, empty);
  // the block's slabs: blockIdx.y, + gridDim.y, ...; a slab whose length is
  // at most p0 holds none of the tile's coordinates, and only the last is short
  const int64_t last = (d - 1) / c64 - (p0 >= d - ((d - 1) / c64) * c64 ? 1 : 0);
  const int64_t steps = last < blockIdx.y ? 0 : (last - blockIdx.y) / gridDim.y + 1;

  if (t >= kConsumers) {
    for (int64_t n = 0; n < steps; ++n) {
      if ((n & 31) == 0) {
        // lane m loads every row's shift of step n + m: one load latency
        // per 32 steps
        const int64_t sm = blockIdx.y + (n + lane) * gridDim.y;
        for (int j = 0; j < R; ++j)
          shift_of[j][lane] =
              n + lane < steps ? static_cast<uint32_t>(shifts[j * num_slabs + sm]) : 0u;
        __syncwarp();
      }
      const int64_t s = blockIdx.y + n * gridDim.y;
      const int st = static_cast<int>(n % kQueryStages);
      const int len = static_cast<int>(min64(kSize, min64(c64, d - s * c64) - p0));
      acquire_slot<kQueryStages>(empty, n, st, lane);
#pragma unroll 1
      for (int j = 0; j < R; ++j) {
        const uint32_t shift = shift_of[j][n & 31];
        const uint32_t start = p0 >= c - shift ? p0 - (c - shift) : p0 + shift;
        const float* row = table + j * c64;
        const int e = offset16(row + start);
        if (lane == 0) e_of[st][j] = e;
        stage_window(ring + (st * R + j) * kSlotWindow, e, row, c, c, start, len, &full[st], lane);
      }
      publish_slot(full, st, lane);
    }
  } else {
    for (int64_t n = 0; n < steps; ++n) {
      const int64_t s = blockIdx.y + n * gridDim.y;
      const int st = static_cast<int>(n % kQueryStages);
      const int len = static_cast<int>(min64(kSize, min64(c64, d - s * c64) - p0));
      mbar_wait(&full[st], static_cast<uint32_t>((n / kQueryStages) & 1));
      const float* win = ring + st * R * kSlotWindow;
      const uint32_t i0 = static_cast<uint32_t>(s * c64) + p0;
      float* slab_out = out + s * c64 + p0;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int w = t + k * kConsumers;
        if (len < kSize && w >= len) break;
        const uint32_t i = i0 + w;
        float val[R];
#pragma unroll
        for (int j = 0; j < R; ++j)
          val[j] = apply_sign(win[j * kSlotWindow + e_of[st][j] + w], sign_mask(i, key_of[j]));
#pragma unroll
        for (int phase = 0; phase < R; ++phase) {
#pragma unroll
          for (int m = phase & 1; m + 1 < R; m += 2) {
            const float lo = fminf(val[m], val[m + 1]);
            const float hi = fmaxf(val[m], val[m + 1]);
            val[m] = lo;
            val[m + 1] = hi;
          }
        }
        slab_out[w] = val[(R - 1) / 2];
      }
      release_slot(empty, st, lane);
    }
  }
}

template <int R>
cudaError_t launch_query(const float* table, const int32_t* shifts, const uint32_t* ks,
                         float* out, int64_t d, int64_t c, int64_t num_slabs,
                         cudaStream_t stream) {
  // above 48 KB dynamic shared memory must be requested, or the launch is
  // refused; requested for every r, on the current device
  constexpr int kSize = QueryTile<R>::kSize;
  const int smem = QueryTile<R>::kSmem;
  int device = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      query_tiles<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call does not report it
    return err;
  }
  // each block walks every gridDim.y-th slab of its tile; enough blocks to
  // fill the card, each with as many slabs as that leaves for its ring
  const int64_t tiles = (c + kSize - 1) / kSize;
  int64_t gy = (int64_t{kBlocksPerSm} * sms + tiles - 1) / tiles;
  gy = gy < num_slabs ? gy : num_slabs;
  gy = gy < kMaxGridY ? gy : kMaxGridY;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(gy));
  query_tiles<R><<<grid, kThreads, smem, stream>>>(table, shifts, ks, out, d, c, num_slabs);
  return cudaGetLastError();
}

bool bad_shape(int64_t d, int64_t c, int32_t r, int64_t num_slabs) {
  return d <= 0 || c <= 0 || c > INT32_MAX || r < 1 || r > kMaxRows ||
         num_slabs != (d + c - 1) / c;
}

// The tree's grid over `tiles` (row, bucket tile) pairs: `blocks` blocks,
// the pairs split evenly over them (so blocks differ by at most one pair),
// and `smem` bytes of dynamic shared memory a block (the ring and the sums
// of its pairs). One wave where the sums fit: kTreeBlocksPerSm blocks an SM
// if that many fit, else fewer; else as many pairs a block as fit, in more
// than one wave.
cudaError_t tree_grid(int64_t tiles, int64_t& blocks, int& smem) {
  int device = 0, sms = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, accumulate_tree_tiles);
  if (err != cudaSuccess) return err;
  const int64_t ring = sizeof(float) * kAccStages * kWindow, tile = sizeof(float) * kTile;
  const int64_t room = optin - static_cast<int64_t>(fa.sharedSizeBytes);
  // the most any launch may ask for; each launch asks for its own smem
  err = cudaFuncSetAttribute(accumulate_tree_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(room));
  for (int bps = kTreeBlocksPerSm; bps >= 1 && err == cudaSuccess; --bps) {
    blocks = tiles < int64_t{bps} * sms ? tiles : int64_t{bps} * sms;
    const int64_t bytes = ring + (tiles + blocks - 1) / blocks * tile;
    if (bytes > room) continue;
    smem = static_cast<int>(bytes);
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, accumulate_tree_tiles,
                                                        kTreeThreads, smem);
    if (err == cudaSuccess && fit >= bps) return cudaSuccess;
  }
  const int64_t per = (room - ring) / tile;
  blocks = (tiles + per - 1) / per;
  smem = static_cast<int>(ring + per * tile);
  return err;
}

}  // namespace

extern "C" int sketch_accumulate(const float* v, const int32_t* shifts,
                                 const uint32_t* ks, float* out, int64_t d,
                                 int64_t c, int32_t r, int64_t num_slabs,
                                 void* stream) {
  if (bad_shape(d, c, r, num_slabs)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float) * kAccStages * kWindow);
  const cudaError_t err = cudaFuncSetAttribute(
      accumulate_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call does not report it
    return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((c + kTile - 1) / kTile), static_cast<unsigned>(r));
  accumulate_tiles<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      v, shifts, ks, out, d, c, num_slabs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sketch_query(const float* table, const int32_t* shifts,
                            const uint32_t* ks, float* out, int64_t d, int64_t c,
                            int32_t r, int64_t num_slabs, void* stream) {
  if (bad_shape(d, c, r, num_slabs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (r) {
#define SKETCH_QUERY_CASE(R) \
  case R: err = launch_query<R>(table, shifts, ks, out, d, c, num_slabs, st); break;
    SKETCH_QUERY_CASE(1) SKETCH_QUERY_CASE(2) SKETCH_QUERY_CASE(3)
    SKETCH_QUERY_CASE(4) SKETCH_QUERY_CASE(5) SKETCH_QUERY_CASE(6)
    SKETCH_QUERY_CASE(7) SKETCH_QUERY_CASE(8) SKETCH_QUERY_CASE(9)
    SKETCH_QUERY_CASE(10) SKETCH_QUERY_CASE(11) SKETCH_QUERY_CASE(12)
    SKETCH_QUERY_CASE(13) SKETCH_QUERY_CASE(14) SKETCH_QUERY_CASE(15)
    SKETCH_QUERY_CASE(16)
#undef SKETCH_QUERY_CASE
  }
  return static_cast<int>(err);
}

extern "C" int sketch_tree_max_leaves() { return kTreeLeaves; }

// `leaves` is int64 [3, count] in host memory: each leaf's device address,
// then the coordinate of its first element, then the coordinate past its
// last. fresh != 0 starts the table from +0 and reads nothing of it.
extern "C" int sketch_accumulate_tree(float* table, const int64_t* leaves, int32_t count,
                                      const int32_t* shifts, const uint32_t* ks, int64_t d,
                                      int64_t c, int32_t r, int64_t num_slabs, int32_t fresh,
                                      void* stream) {
  if (bad_shape(d, c, r, num_slabs) || count < 1 || count > kTreeLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  TreeLeaves tree = {};
  tree.count = count;
  int64_t past = 0;
  for (int m = 0; m < count; ++m) {
    tree.ptr[m] = reinterpret_cast<const float*>(static_cast<uintptr_t>(leaves[m]));
    tree.begin[m] = leaves[count + m];
    tree.end[m] = leaves[2 * count + m];
    if (tree.ptr[m] == nullptr || tree.begin[m] < past || tree.end[m] <= tree.begin[m] ||
        tree.end[m] > d)
      return static_cast<int>(cudaErrorInvalidValue);
    past = tree.end[m];
  }
  int64_t blocks = 0;
  int smem = 0;
  const cudaError_t err = tree_grid((c + kTile - 1) / kTile * r, blocks, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call does not report it
    return static_cast<int>(err);
  }
  accumulate_tree_tiles<<<static_cast<unsigned>(blocks), kTreeThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(tree, table, shifts, ks, c, r,
                                                               num_slabs, fresh);
  return static_cast<int>(cudaGetLastError());
}
