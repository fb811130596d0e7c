// One decode token of Kimi Delta Attention on each (slot, head)'s state,
// fp32, in place.
//
// For row bh = b * H + h (H heads of d = dv = 128), with q^ = q / |q| and
// k^ = k / |k| (1e-6 under the root):
//   S      <- Diag(exp g) S                       (row i decays by exp g_i)
//   u_j     = sum_i k^_i S_ij
//   S_ij   <- S_ij + k^_i beta (v_j - u_j)
//   out_j   = scale sum_i q^_i S_ij
// q, k, v, g (rows, 128), beta (rows,), S (rows, 128, 128) row-major (key
// channel i, value channel j), out (rows, 128); all fp32.
//
// It replaces no TPU kernel: the TPU package has no linear-attention
// mixer.  It is bound by S's bytes (64 KB a row, read once and written
// once; ~7 operations an element).  One block a row, 128 threads, thread
// j owning column j: the column's 128 values are loaded into registers
// (a warp reads 128 contiguous bytes of a state row a load, every load
// issued before the first is used, so 64 KB a block are in flight), the
// decay and the dot product u_j run on them, then the update, the output's
// dot product and the store.  Each column is independent of the others
// (u_j and out_j read only column j), so nothing is exchanged but the two
// norms' sums and the row's normed q, k and decay, in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;          // d = dv
constexpr int kWarps = kD / 32;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kD)
kda_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ beta, float* __restrict__ S,
                  float* __restrict__ out, float scale) {
  __shared__ float qs[kD], ks[kD], decay[kD];
  __shared__ float part[2][kWarps];
  const int j = threadIdx.x, warp = j / 32, lane = j % 32;
  const int64_t row = blockIdx.x;
  float* col = S + row * kD * kD + j;

  // the state's column first: its loads are in flight during the norms
  float s[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) s[i] = col[i * kD];

  const float qj = q[row * kD + j], kj = k[row * kD + j];
  const float sq = warp_sum(qj * qj), sk = warp_sum(kj * kj);
  if (lane == 0) {
    part[0][warp] = sq;
    part[1][warp] = sk;
  }
  __syncthreads();
  float tq = 0.f, tk = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    tq += part[0][w];
    tk += part[1][w];
  }
  qs[j] = qj * rsqrtf(tq + kEps) * scale;
  ks[j] = kj * rsqrtf(tk + kEps);
  decay[j] = expf(g[row * kD + j]);
  __syncthreads();

  float u = 0.f;
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    s[i] *= decay[i];
    u = fmaf(ks[i], s[i], u);
  }
  const float delta = beta[row] * (v[row * kD + j] - u);
  float o = 0.f;
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    s[i] = fmaf(ks[i], delta, s[i]);
    o = fmaf(qs[i], s[i], o);
    col[i * kD] = s[i];
  }
  out[row * kD + j] = o;
}

}  // namespace

// q, k, v, g, out (rows, 128), beta (rows,), S (rows, 128, 128): fp32,
// contiguous.  Returns cudaGetLastError() after the launch, or -1 for
// arguments it does not take.
extern "C" int repro_kda_decode(const void* q, const void* k, const void* v,
                                const void* g, const void* beta, void* S,
                                void* out, int rows, float scale,
                                void* stream) {
  if (rows < 1) return -1;
  kda_decode_kernel<<<rows, kD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<float*>(S),
      static_cast<float*>(out), scale);
  return static_cast<int>(cudaGetLastError());
}
