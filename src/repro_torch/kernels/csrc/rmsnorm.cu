// RMSNorm over the last axis for Hopper (sm_90a):
//   out = x * rsqrt(mean(x^2) + eps) * w,
// computed in fp32 and cast once to x's dtype.  x and out are (rows, d)
// row-major and contiguous, w is (d,); x in fp32 or bf16, w in fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel.  There
// each grid step normalised a (block_rows, d) tile resident in VMEM, the
// grid running in order on one core.
//
// What bounds it on an H100: bytes, and below a few hundred rows the
// latency of one launch.  A row of d values does 3 d flops against 2 d
// elements moved, far below the card's ~20 flop/byte fp32 ridge, so the
// least time is (x + out + w bytes) / 3.35 TB/s; at a decode step's 8 rows
// that is 0.016 us, and the time is the launch plus one dependent trip to
// memory.  The design keeps that critical path to one read, a reduction
// and one write:
//
// - A lane holds S chunks of the row in registers, a chunk 16 bytes (VEC:
//   8 bf16 or 4 fp32 values) or one value; S is a template argument,
//   the warps a row (1-8, blockDim.x / 32) a launch argument.  The Python
//   wrapper's legalize picks one of two layouts.  Few rows (up to two
//   blocks an SM): a launch waits on the chain a warp runs after its one
//   load, so a row spreads over the warps that give each lane one chunk.
//   Many rows: bytes govern, so a row takes the fewest warps that hold it
//   in at most 8 chunks a lane.  qwen2's d 1536 in bf16: a decode step's
//   8 rows 6 warps a row, a chunk a lane; a 1,006-row prefill one warp a
//   row, 6 chunks a lane.  Within a warp the sum of squares needs only
//   __shfl_xor_sync; a row of several warps adds one shared-memory step
//   behind __syncthreads, its block holding that one row.  Rows of one
//   warp go up to 4 to a block (blockDim.y) and need no shared memory.
// - 16-byte loads and stores (VEC): neighbouring lanes on neighbouring
//   16-byte chunks.  The scalar template (VEC false: one value a copy,
//   kScalarSlots values a lane) takes what the vector one cannot: d not a
//   multiple of the chunk, or x, w or out not 16-byte aligned.
// - One memory round trip: a lane loads its slice of w first and keeps it
//   in registers for every row it walks, so w's loads are in flight with
//   the first row's x and never on a later row's critical path.
// - The grid: a block for each blockDim.y rows, capped at the SMs times
//   the blocks resident on each; a grid-stride loop walks the rest.
//
// The reference's block_rows knob is kept by the Python wrapper, recorded
// beside the run geometry, and walked by the plain version; it does not
// change the result, since rows are independent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;  // threads of a block at most
constexpr int kMaxWarps = 8;        // warps a row at most
constexpr int kScalarSlots = 32;    // values a lane holds (scalar template)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// N values of T moved by one load or store (16 bytes for a vector chunk).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// The E values of w beside one chunk of x, in loads of at most 16 bytes
// (bf16 x with fp32 w: two 16-byte loads a chunk).
template <typename TW, int E>
struct WChunk {
  static constexpr int kPiece =
      E * sizeof(TW) > 16 ? 16 / static_cast<int>(sizeof(TW)) : E;
  Pack<TW, kPiece> p[E / kPiece];

  __device__ __forceinline__ void load(const TW* src) {
    const Pack<TW, kPiece>* s = reinterpret_cast<const Pack<TW, kPiece>*>(src);
#pragma unroll
    for (int i = 0; i < E / kPiece; ++i) p[i] = s[i];
  }
  __device__ __forceinline__ float operator[](int e) const {
    return to_float(p[e / kPiece].v[e % kPiece]);
  }
};

template <typename T, typename TW, bool VEC, int S>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w,
               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int E = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int lanes = blockDim.x;  // lanes a row
  const int lane = threadIdx.x;
  const int chunks = d / E;  // legalize: d % E == 0 where VEC

  WChunk<TW, E> wr[S];  // this lane's slice of w, for every row it walks
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int c = lane + i * lanes;
    if (c < chunks) wr[i].load(w + c * E);
  }

  int parity = 0;
  for (int row = blockIdx.x * blockDim.y + threadIdx.y; row < rows;
       row += gridDim.x * blockDim.y) {
    const Pack<T, E>* xr =
        reinterpret_cast<const Pack<T, E>*>(x + (int64_t)row * d);
    Pack<T, E> v[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int c = lane + i * lanes;
      if (c < chunks) v[i] = xr[c];
    }
    // each chunk's squares summed apart and added after: a short chain
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (lane + i * lanes < chunks) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float f = to_float(v[i].v[e]);
          part = fmaf(f, f, part);
        }
        ss += part;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lanes > 32) {
      // a row of several warps is its block's only row (blockDim.y == 1),
      // so every thread takes this branch; partial is double-buffered by
      // parity, so the next row's writes cannot race this row's reads
      __shared__ float partial[2][kMaxWarps];
      if ((lane & 31) == 0) partial[parity][lane >> 5] = ss;
      __syncthreads();
      // all kMaxWarps slots read at once (the row's own selected), so the
      // reads are issued together, not one dependent read a warp
      ss = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxWarps; ++j) {
        const float p = partial[parity][j];
        ss += j < lanes / 32 ? p : 0.f;
      }
      parity ^= 1;
    }
    // IEEE sqrt and division (no fast-math): rsqrt to the last bit
    const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

    Pack<T, E>* orow = reinterpret_cast<Pack<T, E>*>(out + (int64_t)row * d);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int c = lane + i * lanes;
      if (c < chunks) {
        Pack<T, E> o;
#pragma unroll
        for (int e = 0; e < E; ++e)
          o.v[e] = from_float<T>(to_float(v[i].v[e]) * inv * wr[i][e]);
        orow[c] = o;
      }
    }
  }
}

template <typename T, typename TW, bool VEC, int S>
int launch(const void* x, const void* w, void* out, int rows, int d,
           float eps, int warps_per_row, int rows_per_block, int grid,
           cudaStream_t s) {
  constexpr int E = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  if (warps_per_row < 1 || warps_per_row > kMaxWarps) return -1;
  if (d > S * E * 32 * warps_per_row || (VEC && d % E != 0)) return -1;
  if (warps_per_row > 1 && rows_per_block != 1) return -1;
  if (32 * warps_per_row * rows_per_block > kBlockThreads) return -1;
  rmsnorm_kernel<T, TW, VEC, S>
      <<<grid, dim3(32 * warps_per_row, rows_per_block), 0, s>>>(
          static_cast<const T*>(x), static_cast<const TW*>(w),
          static_cast<T*>(out), rows, d, eps);
  return 0;
}

// The templates legalize can ask for: vector, 1, 2, 4, 6 or 8 slots;
// scalar, kScalarSlots values a lane.
template <typename T, typename TW>
int dispatch(int vec, int warps_per_row, int slots, const void* x,
             const void* w, void* out, int rows, int d, float eps,
             int rows_per_block, int grid, cudaStream_t s) {
#define RMSNORM_LAUNCH(V, S)                                                  \
  launch<T, TW, V, S>(x, w, out, rows, d, eps, warps_per_row, rows_per_block, \
                      grid, s)
  if (!vec)
    return slots == kScalarSlots ? RMSNORM_LAUNCH(false, kScalarSlots) : -1;
  switch (slots) {
    case 1: return RMSNORM_LAUNCH(true, 1);
    case 2: return RMSNORM_LAUNCH(true, 2);
    case 4: return RMSNORM_LAUNCH(true, 4);
    case 6: return RMSNORM_LAUNCH(true, 6);
    case 8: return RMSNORM_LAUNCH(true, 8);
  }
  return -1;
#undef RMSNORM_LAUNCH
}

}  // namespace

// dtype / w_dtype: 0 = float32, 1 = bfloat16.  vec: 1 for the 16-byte
// template (x, w and out 16-byte aligned, d a multiple of 16 bytes of x),
// 0 for the scalar one.  warps_per_row, slots, rows_per_block and grid are
// the run geometry the wrapper's legalize chose.  Returns
// cudaGetLastError() after the launch (0 on success), or -1 when the
// arguments name no template or break its limits.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int d, float eps, int dtype,
                             int w_dtype, int vec, int warps_per_row,
                             int slots, int rows_per_block, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1 || rows_per_block < 1 || grid < 1) return -1;
  if (vec && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
               reinterpret_cast<uintptr_t>(out)) & 15))
    return -1;
  int rc = -1;
  if (dtype == 0 && w_dtype == 0) {
    rc = dispatch<float, float>(vec, warps_per_row, slots, x, w, out, rows,
                                d, eps, rows_per_block, grid, s);
  } else if (dtype == 0 && w_dtype == 1) {
    rc = dispatch<float, __nv_bfloat16>(vec, warps_per_row, slots, x, w, out,
                                        rows, d, eps, rows_per_block, grid, s);
  } else if (dtype == 1 && w_dtype == 0) {
    rc = dispatch<__nv_bfloat16, float>(vec, warps_per_row, slots, x, w, out,
                                        rows, d, eps, rows_per_block, grid, s);
  } else if (dtype == 1 && w_dtype == 1) {
    rc = dispatch<__nv_bfloat16, __nv_bfloat16>(vec, warps_per_row, slots, x,
                                                w, out, rows, d, eps,
                                                rows_per_block, grid, s);
  }
  if (rc != 0) return -1;
  return static_cast<int>(cudaGetLastError());
}
