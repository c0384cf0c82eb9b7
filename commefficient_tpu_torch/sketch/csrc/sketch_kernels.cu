// Rotation-family Count-Sketch kernels for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package
// (commefficient_tpu/sketch/pallas_kernels.py):
//
//   sketch_accumulate  <- _accumulate_kernel (entered via _accumulate_call /
//                         sketch_vec): [d] vector -> [r, c] table.
//   sketch_query       <- _query_kernel (entered via _query_call / query_all):
//                         [r, c] table -> [d] lower-median estimates.
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
// (row, coordinate)) is far below the card's integer and float rates.
//
// Design. The TPU kernel streams each slab once while the whole table stays
// resident in VMEM; a Hopper block cannot hold the table, and blocks run in
// no order, so the slab loop moves inside the thread instead:
//
// - accumulate: one thread per (row j, bucket b), grid (ceil(c/256), r).
//   The thread walks the slabs in order, s = 0..S-1, adding
//   sign(i) * v[i] for the coordinate i = s*c + (b - shift[j,s]) mod c that
//   the rotation puts in its bucket. No atomics: each bucket is the plain
//   version's slab-order fold, and sign * v is exact, so the result equals
//   the plain PyTorch version bitwise (up to the sign of a zero sum).
//   Neighbouring threads read neighbouring v[i], so loads coalesce. This
//   first design reads v once per row, r times the minimum input traffic,
//   mostly from the 50 MB L2, which holds all of v; making it fast is later
//   work.
// - query: one thread per coordinate i gathers its r signed table entries
//   (contiguous across neighbouring threads within a slab) and takes the
//   lower median, element (r-1)/2, through an odd-even transposition network
//   in registers. The median selects one of its inputs, so it equals the
//   plain sort-based version bitwise (up to the sign of zero).
//
// Index arithmetic is int64 throughout. Every entry returns cudaGetLastError()
// after its launch; the launches are asynchronous on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float sign_of(int64_t i, uint32_t key) {
  const uint32_t h = fmix32(static_cast<uint32_t>(i) ^ key);
  return ((h >> 16) & 1u) ? -1.0f : 1.0f;
}

__global__ void accumulate_kernel(const float* __restrict__ v,
                                  const int32_t* __restrict__ shifts,
                                  const uint32_t* __restrict__ ks,
                                  float* __restrict__ out,
                                  int64_t d, int64_t c, int64_t num_slabs) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y;
  if (b >= c) return;
  const uint32_t key = ks[j];
  const int32_t* row_shifts = shifts + j * num_slabs;
  float acc = 0.0f;
  for (int64_t s = 0; s < num_slabs; ++s) {
    int64_t p = b - row_shifts[s];
    if (p < 0) p += c;
    const int64_t i = s * c + p;
    if (i < d) acc += sign_of(i, key) * v[i];
  }
  out[j * c + b] = acc;
}

template <int R>
__global__ void query_kernel(const float* __restrict__ table,
                             const int32_t* __restrict__ shifts,
                             const uint32_t* __restrict__ ks,
                             float* __restrict__ out,
                             int64_t d, int64_t c, int64_t num_slabs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= d) return;
  const int64_t s = i / c;
  const int64_t p = i - s * c;
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    int64_t q = p + shifts[j * num_slabs + s];
    if (q >= c) q -= c;
    v[j] = sign_of(i, ks[j]) * table[j * c + q];
  }
#pragma unroll
  for (int phase = 0; phase < R; ++phase) {
#pragma unroll
    for (int k = phase & 1; k + 1 < R; k += 2) {
      const float lo = fminf(v[k], v[k + 1]);
      const float hi = fmaxf(v[k], v[k + 1]);
      v[k] = lo;
      v[k + 1] = hi;
    }
  }
  out[i] = v[(R - 1) / 2];
}

template <int R>
void launch_query(const float* table, const int32_t* shifts, const uint32_t* ks,
                  float* out, int64_t d, int64_t c, int64_t num_slabs,
                  cudaStream_t stream) {
  const int64_t blocks = (d + kThreads - 1) / kThreads;
  query_kernel<R><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, shifts, ks, out, d, c, num_slabs);
}

bool bad_shape(int64_t d, int64_t c, int32_t r, int64_t num_slabs) {
  return d <= 0 || c <= 0 || r < 1 || r > kMaxRows ||
         num_slabs != (d + c - 1) / c || (c + kThreads - 1) / kThreads > 0x7FFFFFFF ||
         (d + kThreads - 1) / kThreads > 0x7FFFFFFF;
}

}  // namespace

extern "C" int sketch_accumulate(const float* v, const int32_t* shifts,
                                 const uint32_t* ks, float* out, int64_t d,
                                 int64_t c, int32_t r, int64_t num_slabs,
                                 void* stream) {
  if (bad_shape(d, c, r, num_slabs)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((c + kThreads - 1) / kThreads),
                  static_cast<unsigned>(r));
  accumulate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, shifts, ks, out, d, c, num_slabs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sketch_query(const float* table, const int32_t* shifts,
                            const uint32_t* ks, float* out, int64_t d, int64_t c,
                            int32_t r, int64_t num_slabs, void* stream) {
  if (bad_shape(d, c, r, num_slabs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
#define SKETCH_QUERY_CASE(R) \
  case R: launch_query<R>(table, shifts, ks, out, d, c, num_slabs, st); break;
    SKETCH_QUERY_CASE(1) SKETCH_QUERY_CASE(2) SKETCH_QUERY_CASE(3)
    SKETCH_QUERY_CASE(4) SKETCH_QUERY_CASE(5) SKETCH_QUERY_CASE(6)
    SKETCH_QUERY_CASE(7) SKETCH_QUERY_CASE(8) SKETCH_QUERY_CASE(9)
    SKETCH_QUERY_CASE(10) SKETCH_QUERY_CASE(11) SKETCH_QUERY_CASE(12)
    SKETCH_QUERY_CASE(13) SKETCH_QUERY_CASE(14) SKETCH_QUERY_CASE(15)
    SKETCH_QUERY_CASE(16)
#undef SKETCH_QUERY_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
