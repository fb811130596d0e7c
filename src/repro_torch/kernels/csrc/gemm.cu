// Tiled GEMM C = A @ B for Hopper (sm_90a), fp32 or bf16 inputs, fp32
// accumulation, output in A's dtype.  Row-major, contiguous operands:
// A (M, K), B (K, N), C (M, N).
//
// Replaces the TPU kernel repro/kernels/gemm.py::_gemm_kernel.  There the
// grid was (M/bm, N/bn, K/bk) run in order on one core, with an fp32 VMEM
// scratch accumulator carried across the sequential k axis and the inputs
// zero-padded to tile multiples.  Here one thread block owns one (BM, BN)
// output tile and runs the whole K loop itself, in steps of BK, with the
// accumulator in registers; loads are masked at the M/N/K tails instead of
// padding, and the store is masked instead of slicing the padded result.
//
// What bounds it on an H100: the ResNet-18 im2col products at batch 8 do
// 2*M*N*K = 0.9 to 1.9 GFLOP each against 12 to 85 MB of fp32 operands,
// i.e. 22 to 106 FLOP per byte, above the 20 FLOP/byte ridge of the fp32
// pipes (67 TFLOP/s, no TF32: the reference holds fp32 to rtol 1e-5) over
// 3.35 TB/s of device memory, so the bound is the arithmetic.  The design answers with register blocking:
// each of the 256 threads keeps a (BM/16) x (BN/16) block of accumulators
// and reads (BM/16 + BN/16) shared-memory words per BM*BN/256 FMAs, and
// every global load is coalesced along the contiguous dimension.  It issues
// plain FFMA, not wgmma/TMA, and has no pipelining across K steps: it is
// the simple, correct first version.
//
// Tile templates (the "run geometry"): BM in {16, 32, 64, 128}, BN in
// {32, 64, 128}, BK in {16, 32}, 256 threads.  Both operand tiles are held
// in fp32 in static shared memory, ((BM + 1) + BN) * BK * 4 bytes, at most
// 32,896 bytes, under the 48 KB static limit of a block.  The Python
// wrapper (repro_torch/kernels/gemm.py::legalize) maps a requested
// GemmConfig onto these templates: per dimension, the largest template not
// above min(requested block, problem size), else the smallest template.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid over the tile

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

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            T* __restrict__ C, int M, int N, int K) {
  constexpr int TM = BM / 16;  // rows per thread, strided by 16
  constexpr int TN = BN / 16;  // columns per thread, strided by 16
  // A is stored transposed (k-major) so the inner loop reads a column of
  // the tile; the +1 keeps the transposing store free of bank conflicts.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive k of one A row (coalesced)
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K)
                     ? to_float(A[(int64_t)gr * K + gc]) : 0.f;
    }
    // consecutive threads read consecutive n of one B row (coalesced)
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N)
                     ? to_float(B[(int64_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(int64_t)r * N + c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<T, BM, BN, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(c), m, n, k);
}

template <typename T, int BM, int BN>
bool dispatch_bk(int bk, const void* a, const void* b, void* c, int m, int n,
                 int k, cudaStream_t s) {
  switch (bk) {
    case 16: launch<T, BM, BN, 16>(a, b, c, m, n, k, s); return true;
    case 32: launch<T, BM, BN, 32>(a, b, c, m, n, k, s); return true;
  }
  return false;
}

template <typename T, int BM>
bool dispatch_bn(int bn, int bk, const void* a, const void* b, void* c,
                 int m, int n, int k, cudaStream_t s) {
  switch (bn) {
    case 32: return dispatch_bk<T, BM, 32>(bk, a, b, c, m, n, k, s);
    case 64: return dispatch_bk<T, BM, 64>(bk, a, b, c, m, n, k, s);
    case 128: return dispatch_bk<T, BM, 128>(bk, a, b, c, m, n, k, s);
  }
  return false;
}

template <typename T>
bool dispatch(int bm, int bn, int bk, const void* a, const void* b, void* c,
              int m, int n, int k, cudaStream_t s) {
  switch (bm) {
    case 16: return dispatch_bn<T, 16>(bn, bk, a, b, c, m, n, k, s);
    case 32: return dispatch_bn<T, 32>(bn, bk, a, b, c, m, n, k, s);
    case 64: return dispatch_bn<T, 64>(bn, bk, a, b, c, m, n, k, s);
    case 128: return dispatch_bn<T, 128>(bn, bk, a, b, c, m, n, k, s);
  }
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success), or -1 when (dtype, bm, bn, bk) names no template.
extern "C" int repro_gemm(const void* a, const void* b, void* c, int m, int n,
                          int k, int dtype, int bm, int bn, int bk,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = dispatch<float>(bm, bn, bk, a, b, c, m, n, k, s);
  } else if (dtype == 1) {
    ok = dispatch<__nv_bfloat16>(bm, bn, bk, a, b, c, m, n, k, s);
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
