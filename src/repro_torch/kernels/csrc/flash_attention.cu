// Flash attention forward for Hopper (sm_90a): grouped-query attention,
// causal and/or sliding-window, online softmax (FlashAttention-2 order),
// fp32 or bf16 in and out, fp32 running max, sum and accumulator.
//
//   q (B, S, HQ, D), k and v (B, S, HKV, D), o (B, S, HQ, D); row-major,
//   contiguous; HQ % HKV == 0; query head h reads KV head h / (HQ / HKV).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel.
// There the grid was (B, HQ, S/bq, S/bk) run in order on one core, with
// the running max / sum / accumulator in VMEM scratch carried across the
// innermost kv axis, fully masked kv blocks skipped by pl.when, and the
// inputs transposed to (B, H, S, D) and zero-padded to block multiples.
// Here one thread block owns one (BQ rows of one head) query tile and runs
// the whole KV loop itself: grid (ceil(S / BQ), B * HQ).  The loop covers
// only the KV tiles the causal and window limits allow (the reference's
// block skip, as loop bounds), the running state lives in registers, tiles
// are read in place from the (B, S, H, D) layout with the S and D tails
// zero-filled, and masked columns get the reference's -1e30 score.
//
// Per KV tile: S = Q K^T (each of the 256 threads, a 16 x 16 grid, owns a
// (BQ/16) x (BK/16) block of scores), scale, mask, row max and row sum by
// shuffles across the 16 threads of a row, P to shared memory, then
// O += P V (each thread owns (BQ/16) x (DP/16) of the accumulator).  All
// products are fp32 FFMA on the CUDA cores, in both dtypes: the fp32 path
// must stay IEEE fp32 (the reference holds it to 1e-5), and one code path
// keeps the kernel simple.  exp is the accurate expf (no fast-math).
//
// What bounds it on an H100: operations.  A causal prefill of S tokens
// does about 2 * HQ * S^2 * D flops against (2 HQ + 2 HKV) * S * D values
// moved; at S = 1024, D = 128 that is ~440 flop/byte, past the bf16
// tensor-core ridge (~295).  This first version issues FFMA, not wgmma, so
// it is far from that bound: it is the simple, correct kernel.
//
// Templates (the "run geometry"): BQ and BK in {16, 32, 64}, DP (head_dim
// padded up) in {16, 32, 64, 128}, 256 threads.  Shared memory, dynamic:
// Q [BQ][DP+1], K [BK][DP+1], V [BK][DP], P [BQ][BK+1], all fp32; the +1
// keeps the column reads of Q K^T free of bank conflicts.  The Python
// wrapper (repro_torch/kernels/flash_attention.py::legalize) picks the
// templates and keeps the footprint under 100 KB, two blocks an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid over the tiles
constexpr float kNegInf = -1e30f;

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
  return __float2bfloat16(v);
}

// max / sum over the 16 threads that share a row (half a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int BQ, int BK, int DP>
constexpr int smem_floats() {
  return BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1);
}

template <typename T, int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int HQ,
             int HKV, int D, float scale, int causal, int window) {
  constexpr int RQ = BQ / 16;  // query rows per thread, strided by 16
  constexpr int CK = BK / 16;  // score columns per thread, strided by 16
  constexpr int CD = DP / 16;  // output columns per thread, strided by 16
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][DP + 1]
  float* Ks = Qs + BQ * (DP + 1);     // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);     // [BK][DP]
  float* Ps = Vs + BK * DP;           // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b = blockIdx.y / HQ;
  const int h = blockIdx.y % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = blockIdx.x * BQ;
  const int64_t q_stride = (int64_t)HQ * D;    // between sequence positions
  const int64_t kv_stride = (int64_t)HKV * D;
  const T* qb = q + (int64_t)b * S * q_stride + (int64_t)h * D;
  const T* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  T* ob = o + (int64_t)b * S * q_stride + (int64_t)h * D;

  for (int e = tid; e < BQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP, s = q0 + r;
    Qs[r * (DP + 1) + c] =
        (s < S && c < D) ? to_float(qb[(int64_t)s * q_stride + c]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  // the KV tiles this query tile can see (the reference's block skip)
  int j_hi = (S + BK - 1) / BK - 1;
  if (causal) j_hi = min(j_hi, (q0 + BQ - 1) / BK);
  int j_lo = 0;
  if (window > 0) {
    const int lo = q0 - window + 2 - BK;  // first k0 with k0+BK-1 >= q0-window+1
    if (lo > 0) j_lo = (lo + BK - 1) / BK;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q is loaded; the last tile's K, V and P are read
    for (int e = tid; e < BK * DP; e += kThreads) {
      const int r = e / DP, c = e % DP, s = k0 + r;
      const bool in = s < S && c < D;
      Ks[r * (DP + 1) + c] =
          in ? to_float(kb[(int64_t)s * kv_stride + c]) : 0.f;
      Vs[r * DP + c] = in ? to_float(vb[(int64_t)s * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DP; ++kk) {
      float a[RQ], kc[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + 16 * i) * (DP + 1) + kk];
#pragma unroll
      for (int c = 0; c < CK; ++c) kc[c] = Ks[(tx + 16 * c) * (DP + 1) + kk];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) sc[i][c] = fmaf(a[i], kc[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = k0 + tx + 16 * c;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        sc[i][c] = ok ? sc[i][c] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = expf(sc[i][c] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * c] = p;
        ps += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];  // a fully masked row
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        ob[(int64_t)row * q_stride + col] = from_float<T>(acc[i][c] / denom);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, HQ, HKV, D;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int BQ, int BK, int DP>
int launch(const Args& a) {
  constexpr int smem = smem_floats<BQ, BK, DP>() * (int)sizeof(float);
  auto kernel = flash_kernel<T, BQ, BK, DP>;
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory needs an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.HQ);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.S, a.HQ, a.HKV,
      a.D, a.scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BQ, int BK>
int dispatch_dp(int dp, const Args& a) {
  switch (dp) {
    case 16: return launch<T, BQ, BK, 16>(a);
    case 32: return launch<T, BQ, BK, 32>(a);
    case 64: return launch<T, BQ, BK, 64>(a);
    case 128: return launch<T, BQ, BK, 128>(a);
  }
  return -1;
}

template <typename T, int BQ>
int dispatch_bk(int bk, int dp, const Args& a) {
  switch (bk) {
    case 16: return dispatch_dp<T, BQ, 16>(dp, a);
    case 32: return dispatch_dp<T, BQ, 32>(dp, a);
    case 64: return dispatch_dp<T, BQ, 64>(dp, a);
  }
  return -1;
}

template <typename T>
int dispatch(int bq, int bk, int dp, const Args& a) {
  switch (bq) {
    case 16: return dispatch_bk<T, 16>(bk, dp, a);
    case 32: return dispatch_bk<T, 32>(bk, dp, a);
    case 64: return dispatch_bk<T, 64>(bk, dp, a);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 on success), or -1 when
// the arguments name no template or a shape it does not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int HQ, int HKV, int D, float scale,
                                     int causal, int window, int dtype,
                                     int bq, int bk, int dp, void* stream) {
  if (B < 1 || S < 1 || HKV < 1 || HQ % HKV != 0 || D < 1 || D > dp)
    return -1;
  const Args a{q, k, v, o, B, S, HQ, HKV, D, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(bq, bk, dp, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bq, bk, dp, a);
  return -1;
}
