// Rotation-family Count-Sketch kernels for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package
// (commefficient_tpu/sketch/pallas_kernels.py):
//
//   sketch_accumulate  <- _accumulate_kernel (entered via _accumulate_call /
//                         sketch_vec): [d] vector -> [r, c] table.
//   sketch_query       <- _query_kernel (entered via _query_call / query_all):
//                         [r, c] table -> [d] lower-median estimates.
//   sketch_accumulate_leaf <- _accumulate_kernel's computation restricted to
//                         one leaf, the coordinates [offset, offset + n) of
//                         the [d] vector, folded into a running [r, c]
//                         table in place (the layerwise sketch path; the
//                         JAX package folds a leaf in pure JAX,
//                         sketch/layerwise.py). Its kernel,
//                         accumulate_leaf_tiles, is accumulate_tiles over
//                         the leaf's slabs; it reads each leaf r times, as
//                         accumulate_tiles reads v, and is bounded by the
//                         same bytes.
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

// The producer warp stages the positions of the rotated window (as
// stage_window) whose slab positions lie in [lo, hi), the leaf's share of
// the slab. Slab position p is element slab_off + p of the leaf
// (slab_off = s * c - offset, negative when the leaf starts inside the
// slab), and only positions in [lo, hi) are copied, so every copy reads
// inside [leaf, leaf + n).
__device__ __forceinline__ void stage_leaf_window(float* win, int e, const float* leaf,
                                                  int64_t slab_off, uint32_t c, uint32_t lo,
                                                  uint32_t hi, uint32_t start, int len,
                                                  uint64_t* bar, int lane) {
  const uint32_t la = minu(len, c - start);  // positions before the wrap
  if (start < hi && lo < start + la) {
    const uint32_t w0 = lo > start ? lo - start : 0u;
    const uint32_t w1 = minu(la, hi - start);
    stage_piece(win, e, static_cast<int>(w0), static_cast<int>(w1),
                leaf + (slab_off + start + w0), bar, lane);
  }
  if (static_cast<uint32_t>(len) > la && lo < len - la) {
    const uint32_t w1 = minu(len, la + hi);
    stage_piece(win, e, static_cast<int>(la + lo), static_cast<int>(w1), leaf + (slab_off + lo),
                bar, lane);
  }
}

// The slab positions [lo, hi) of slab s that hold the leaf's coordinates
// [offset, offset + n).
__device__ __forceinline__ void leaf_range(int64_t s, int64_t c64, int64_t offset, int64_t n,
                                           uint32_t& lo, uint32_t& hi) {
  const int64_t base = s * c64;
  lo = static_cast<uint32_t>(offset > base ? offset - base : 0);
  hi = static_cast<uint32_t>(min64(c64, offset + n - base));
}

// The window of a tile starting at bucket b0 in a slab of shift `shift`
// starts at slab position (b0 - shift) mod c.
__device__ __forceinline__ uint32_t window_start(uint32_t b0, uint32_t shift, uint32_t c) {
  return b0 >= shift ? b0 - shift : b0 + (c - shift);
}

// accumulate_tiles for one leaf, in place: the leaf holds the coordinates
// [offset, offset + n) of the raveled vector, in slabs s0 .. s0 + ns - 1.
// A block owns buckets [b0, b0 + kTile) of row j, starts from the table's
// values and adds the leaf's coordinates that land there, slab by slab in
// order, skipping every position outside the leaf. Folding a model's leaves
// in ravel order into a +0 table therefore adds each (bucket, slab) term
// exactly once and in slab order, the same left fold accumulate_tiles makes
// in registers: the table equals sketch_accumulate of the raveled vector
// bitwise. A block whose tile receives no coordinate of the leaf (only
// possible when the leaf covers no whole slab) returns before it touches
// the leaf or the table.
__global__ void __launch_bounds__(kThreads)
accumulate_leaf_tiles(float* __restrict__ table, const float* __restrict__ leaf,
                      const int32_t* __restrict__ shifts, const uint32_t* __restrict__ ks,
                      int64_t offset, int64_t n, int64_t c64, int64_t num_slabs) {
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
  const int64_t s0 = offset / c64;
  const int64_t ns = (offset + n - 1) / c64 - s0 + 1;
  const int t = threadIdx.x, lane = t & 31;

  if (ns < 3) {  // three slabs or more: the middle one is whole, every tile is touched
    bool touched = false;
    for (int64_t s = s0; s < s0 + ns; ++s) {
      uint32_t lo, hi;
      leaf_range(s, c64, offset, n, lo, hi);
      const uint32_t start = window_start(b0, static_cast<uint32_t>(row_shifts[s]), c);
      const uint32_t la = minu(len, c - start);
      touched |= (start < hi && lo < start + la) || (static_cast<uint32_t>(len) > la && lo < len - la);
    }
    if (!touched) return;
  }

  // producer lane m holds the shift of leaf slab 32q + m while it stages
  // slabs 32q .. 32q + 31
  uint32_t lane_shift =
      t >= kConsumers && lane < ns ? static_cast<uint32_t>(row_shifts[s0 + lane]) : 0u;
  init_ring<kAccStages>(full, empty);

  if (t >= kConsumers) {
    for (int64_t m = 0; m < ns; ++m) {
      if ((m & 31) == 0 && m > 0)
        lane_shift = m + lane < ns ? static_cast<uint32_t>(row_shifts[s0 + m + lane]) : 0u;
      const uint32_t shift = __shfl_sync(0xFFFFFFFFu, lane_shift, static_cast<int>(m & 31));
      const int st = static_cast<int>(m % kAccStages);
      acquire_slot<kAccStages>(empty, m, st, lane);
      const int64_t s = s0 + m;
      const uint32_t start = window_start(b0, shift, c);
      const int64_t slab_off = s * c64 - offset;
      // the element offset of window position 0 within 16 bytes, as if the
      // leaf extended over the whole slab
      const int e = static_cast<int>((offset16(leaf) + slab_off + start) & 3);
      if (lane == 0) {
        start_of[st] = start;
        e_of[st] = e;
      }
      uint32_t lo, hi;
      leaf_range(s, c64, offset, n, lo, hi);
      stage_leaf_window(windows + st * kWindow, e, leaf, slab_off, c, lo, hi, start, len,
                        &full[st], lane);
      publish_slot(full, st, lane);
    }
  }

  float* row_out = table + j * c64 + b0;
  float acc[kPerThread];
  if (t < kConsumers) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int w = t + k * kConsumers;
      acc[k] = w < len ? row_out[w] : 0.0f;
    }
    const uint32_t key = fold_key(ks[j]);
    for (int64_t m = 0; m < ns; ++m) {
      const int st = static_cast<int>(m % kAccStages);
      mbar_wait(&full[st], static_cast<uint32_t>((m / kAccStages) & 1));
      const int64_t s = s0 + m;
      const uint32_t start = start_of[st];
      uint32_t lo, hi;
      leaf_range(s, c64, offset, n, lo, hi);
      const uint32_t slab_base = static_cast<uint32_t>(s * c64);  // uint32(i), as hashed
      const float* win = windows + st * kWindow + e_of[st];
      if (len == kTile && start >= lo && start + kTile <= hi) {
        // whole tile inside the leaf, no wrap: position w is coordinate i0 + w
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
    }
  }

  // back through shared memory, four consecutive buckets a store, as
  // accumulate_tiles writes its sums
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

extern "C" int sketch_accumulate_leaf(float* table, const float* leaf, const int32_t* shifts,
                                      const uint32_t* ks, int64_t offset, int64_t n, int64_t d,
                                      int64_t c, int32_t r, int64_t num_slabs, void* stream) {
  if (bad_shape(d, c, r, num_slabs) || n < 1 || offset < 0 || offset > d - n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float) * kAccStages * kWindow);
  const cudaError_t err = cudaFuncSetAttribute(
      accumulate_leaf_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call does not report it
    return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((c + kTile - 1) / kTile), static_cast<unsigned>(r));
  accumulate_leaf_tiles<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, leaf, shifts, ks, offset, n, c, num_slabs);
  return static_cast<int>(cudaGetLastError());
}
