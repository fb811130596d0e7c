// RMSNorm over the last axis for Hopper (sm_90a):
//   out = x * rsqrt(mean(x^2) + eps) * w,
// computed in fp32 and cast once to x's dtype.  x and out are (rows, d)
// row-major and contiguous, w is (d,); x in fp32 or bf16, w in fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel.  There
// each grid step normalised a (block_rows, d) tile resident in VMEM, the
// grid running in order on one core.  Here one thread block owns one row:
// its 256 threads hold the whole row in registers (VPT values each, VPT a
// compiled template, so d <= 256 * 32 = 8192), take the sum of squares in
// fp32 with a warp-shuffle reduction and one shared-memory step across the
// 8 warps, and write the normalised row.  Every element is read once and
// written once; consecutive threads touch consecutive elements.
//
// What bounds it on an H100: bytes.  A row of d values does 3 d flops
// against 2 d elements moved, far below the card's ~20 flop/byte fp32
// ridge, so the least time is (x + out + w bytes) / 3.35 TB/s.  One block
// a row gives the LM's prefill (rows = prompt tokens, up to thousands) as
// many blocks as rows; a decode step (rows = batch slots) is launch-bound.
//
// The reference's block_rows knob is kept by the Python wrapper, recorded
// beside the run geometry (one row per block), and walked by the plain
// version; it does not change the result, since rows are independent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T, typename TW, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  __shared__ float partial[kWarps];
  const int tid = threadIdx.x;
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* outr = out + (int64_t)blockIdx.x * d;

  float v[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * kThreads;
    v[i] = c < d ? to_float(xr[c]) : 0.f;
    ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += partial[i];
  // IEEE sqrt and division (no fast-math): rsqrt to the last bit
  const float inv = 1.0f / sqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * kThreads;
    if (c < d) outr[c] = from_float<T>(v[i] * inv * to_float(w[c]));
  }
}

template <typename T, typename TW>
bool dispatch(int vpt, const void* x, const void* w, void* out, int rows,
              int d, float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const TW* wp = static_cast<const TW*>(w);
  T* op = static_cast<T*>(out);
  switch (vpt) {
    case 1: rmsnorm_kernel<T, TW, 1><<<rows, kThreads, 0, s>>>(xp, wp, op, d, eps); return true;
    case 2: rmsnorm_kernel<T, TW, 2><<<rows, kThreads, 0, s>>>(xp, wp, op, d, eps); return true;
    case 4: rmsnorm_kernel<T, TW, 4><<<rows, kThreads, 0, s>>>(xp, wp, op, d, eps); return true;
    case 8: rmsnorm_kernel<T, TW, 8><<<rows, kThreads, 0, s>>>(xp, wp, op, d, eps); return true;
    case 16: rmsnorm_kernel<T, TW, 16><<<rows, kThreads, 0, s>>>(xp, wp, op, d, eps); return true;
    case 32: rmsnorm_kernel<T, TW, 32><<<rows, kThreads, 0, s>>>(xp, wp, op, d, eps); return true;
  }
  return false;
}

}  // namespace

// dtype / w_dtype: 0 = float32, 1 = bfloat16.  vpt: values per thread, a
// compiled template with vpt * 256 >= d.  Returns cudaGetLastError() after
// the launch (0 on success), or -1 when the arguments name no template.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int d, float eps, int dtype,
                             int w_dtype, int vpt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1 || d > kThreads * vpt) return -1;
  bool ok = false;
  if (dtype == 0 && w_dtype == 0) {
    ok = dispatch<float, float>(vpt, x, w, out, rows, d, eps, s);
  } else if (dtype == 0 && w_dtype == 1) {
    ok = dispatch<float, __nv_bfloat16>(vpt, x, w, out, rows, d, eps, s);
  } else if (dtype == 1 && w_dtype == 0) {
    ok = dispatch<__nv_bfloat16, float>(vpt, x, w, out, rows, d, eps, s);
  } else if (dtype == 1 && w_dtype == 1) {
    ok = dispatch<__nv_bfloat16, __nv_bfloat16>(vpt, x, w, out, rows, d, eps,
                                                 s);
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
