// Tiled GEMM C = A @ B for Hopper (sm_90a), fp32 or bf16 inputs, fp32
// accumulation, output in A's dtype.  Row-major, contiguous operands:
// A (M, K), B (K, N), C (M, N).
//
// Replaces the TPU kernel repro/kernels/gemm.py::_gemm_kernel.  There the
// grid was (M/bm, N/bn, K/bk) run in order on one core, with an fp32 VMEM
// scratch accumulator carried across the sequential k axis and the inputs
// zero-padded to tile multiples.  Here a thread block owns one (BM, BN)
// output tile and runs a K loop itself, in steps of BK, with the
// accumulator in registers; loads are masked at the M/N/K tails instead of
// padding, and the store is masked instead of slicing the padded result.
//
// What bounds it on an H100: the ResNet-18 im2col products at batch 8 do
// 2*M*N*K = 0.9 to 1.9 GFLOP each against 12 to 85 MB of fp32 operands,
// i.e. 22 to 106 FLOP per byte, above the 20 FLOP/byte ridge of the fp32
// pipes (67 TFLOP/s, no TF32: the reference holds fp32 to rtol 1e-5) over
// 3.35 TB/s of device memory, so the bound is the arithmetic, and the
// kernel has to keep 132 SMs' FMA pipes busy.  The fp32 kernel
// (gemm_f32_kernel, the main path) does three things for that:
//
// - Split-K.  The ARCO-tuned tile still sets the output tile, but where
//   the tiles are fewer than the SMs (the deep layers get 26-52 tiles) the
//   wrapper (repro_torch/kernels/gemm.py::legalize) cuts K into split_k
//   contiguous slices of whole BK steps, about two blocks an SM in all.
//   Each slice's block writes its partial tile to an fp32 workspace
//   (split_k, M, N); splitk_sum_kernel then adds the slices in slice
//   order and writes C.  No atomics: the result is deterministic.
// - A contiguous register microtile.  Each thread owns TM x TN outputs
//   (8 x 8 at 128 x 128, 256 threads) as float4 groups of 4 rows and 4
//   columns, the two groups of a dimension half a tile apart, so a k step
//   reads A and B from shared memory as float4 (conflict-free across a
//   quarter warp) for TM * TN FMAs.  A is stored k-major (transposed), its
//   rows padded by 4 floats, so a column of the tile is contiguous.
// - A pipelined K loop over two shared-memory stages: the next B tile
//   streams in by cp.async (16 bytes when N % 4 == 0, else 4) and the next
//   A tile is loaded into registers (float4 when K % 4 == 0, else scalars)
//   while the current tile computes; A is stored transposed after the
//   compute, then one barrier a step.  The 16-byte and the scalar copies
//   are separate templates (VEC), so each keeps only its own addresses in
//   registers; the wrapper picks VEC when both row strides and the base
//   pointers allow it, and conv1 (K = 147) takes the scalar one.
//
// It issues plain FFMA, not wgmma/TMA: fp32 must stay IEEE fp32.
//
// bf16 operands are not on the main path and keep the first port's loop
// (gemm_loop_kernel): 256 threads, a (BM/16) x (BN/16) block of
// accumulators a thread at a stride of 16, scalar loads converted to fp32
// into static shared memory, no pipelining and no split.
//
// Tile templates (the "run geometry"): BM in {16, 32, 64, 128}, BN in
// {32, 64, 128}, BK in {16, 32}.  fp32, for each VEC: (BM / TM) * (BN /
// TN) threads with TM = 8 at BM 128 (else 4) and TN = 8 at BN 128 (else
// 4), 32 to 256;
// dynamic shared memory 2 * BK * ((BM + 4) + BN) * 4 bytes, at most
// 66,560 (the opt-in above 48 KB is made once per template).  bf16: 256
// threads, ((BM + 1) + BN) * BK * 4 bytes of static shared memory.  The
// wrapper maps a requested GemmConfig onto these templates: per
// dimension, the largest template not above min(requested block, problem
// size), else the smallest template.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------ bf16: the loop

constexpr int kLoopThreads = 256;  // a 16 x 16 thread grid over the tile

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
__global__ void __launch_bounds__(kLoopThreads)
gemm_loop_kernel(const T* __restrict__ A, const T* __restrict__ B,
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
    for (int e = tid; e < BM * BK; e += kLoopThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K)
                     ? to_float(A[(int64_t)gr * K + gc]) : 0.f;
    }
    // consecutive threads read consecutive n of one B row (coalesced)
    for (int e = tid; e < BK * BN; e += kLoopThreads) {
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


// ------------------------------------------------- fp32: the main path

template <int BM, int BN>
struct Micro {
  static constexpr int TM = BM >= 128 ? 8 : 4;  // rows a thread owns
  static constexpr int TN = BN >= 128 ? 8 : 4;  // columns a thread owns
  static constexpr int TX = BN / TN;            // threads across the tile
  static constexpr int THREADS = (BM / TM) * TX;
};

template <int BM, int BN, int BK>
constexpr int f32_smem_bytes() {  // two stages of As [BK][BM+4], Bs [BK][BN]
  return 2 * BK * ((BM + 4) + BN) * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronous; zero-filled when !pred
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One (BM, BN) tile of C, or of slice blockIdx.z's partial in the
// workspace, over K range [z * k_slice, min(K, (z + 1) * k_slice)).
template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(Micro<BM, BN>::THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K, int k_slice) {
  using U = Micro<BM, BN>;
  constexpr int TM = U::TM, TN = U::TN, NT = U::THREADS;
  constexpr int LDA = BM + 4;          // float4-aligned, conflict-free
  constexpr int A_REG = BM * BK / NT;  // A values a thread stages a step
  constexpr int B_VEC = (BK * BN / 4 + NT - 1) / NT;  // 16-byte copies
  constexpr int B_ONE = (BK * BN + NT - 1) / NT;      // 4-byte copies
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                 // [2][BK][LDA], k-major
  float* Bs = smem + 2 * BK * LDA;  // [2][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % U::TX, ty = tid / U::TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_slice;
  const int ke = min(K, kb + k_slice);
  const int n_steps = (ke - kb + BK - 1) / BK;
  float* out = C + (int64_t)blockIdx.z * M * N;

  // A element i of this thread in a step: VEC, float4 i/4 along k, a warp
  // covering 16 rows x 8 k; else one float, a warp covering 4 rows x 8 k.
  // Both read 32-byte runs of a row, and both transposed stores spread a
  // warp over the 32 banks (LDA = 4 or 20 mod 32).
  auto a_pos = [&](int i, int& r, int& c) {
    if constexpr (VEC) {
      const int e = tid + (i / 4) * NT, w = e / 32, l = e % 32;
      r = (w % (BM / 16)) * 16 + (l & 15);
      c = ((w / (BM / 16)) * 2 + (l >> 4)) * 4 + i % 4;
    } else {
      const int e = tid + i * NT, w = e / 32, l = e % 32;
      r = (w % (BM / 4)) * 4 + (l >> 3);
      c = (w / (BM / 4)) * 8 + (l & 7);
    }
  };
  float stage[A_REG];
  auto load_a = [&](int k0) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < A_REG; i += 4) {
        int r, c;
        a_pos(i, r, c);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < M && k0 + c < ke)
          x = *reinterpret_cast<const float4*>(A + (int64_t)(row0 + r) * K +
                                               k0 + c);
        stage[i] = x.x;
        stage[i + 1] = x.y;
        stage[i + 2] = x.z;
        stage[i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < A_REG; ++i) {
        int r, c;
        a_pos(i, r, c);
        stage[i] = (row0 + r < M && k0 + c < ke)
                       ? A[(int64_t)(row0 + r) * K + k0 + c] : 0.f;
      }
    }
  };
  auto store_a = [&](float* as) {
#pragma unroll
    for (int i = 0; i < A_REG; ++i) {
      int r, c;
      a_pos(i, r, c);
      as[c * LDA + r] = stage[i];
    }
  };
  auto load_b = [&](int k0, float* bs) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < B_VEC; ++i) {
        const int e = tid + i * NT;
        if (e < BK * BN / 4) {
          const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
          const bool in = k0 + r < ke && col0 + c < N;
          cp_async_16(smem_addr(bs + r * BN + c),
                      in ? B + (int64_t)(k0 + r) * N + col0 + c : B, in);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < B_ONE; ++i) {
        const int e = tid + i * NT;
        if (e < BK * BN) {
          const int r = e / BN, c = e % BN;
          const bool in = k0 + r < ke && col0 + c < N;
          cp_async_4(smem_addr(bs + r * BN + c),
                     in ? B + (int64_t)(k0 + r) * N + col0 + c : B, in);
        }
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_b(kb, Bs);
  load_a(kb);
  store_a(As);
  cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_steps;
    if (more) {  // the next step's tiles are in flight during this one
      load_b(kb + (t + 1) * BK, Bs + (cur ^ 1) * BK * BN);
      load_a(kb + (t + 1) * BK);
    }
    const float* as = As + cur * BK * LDA;
    const float* bs = Bs + cur * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            as + kk * LDA + i * (BM / 2) + ty * 4);
        a[4 * i] = x.x;
        a[4 * i + 1] = x.y;
        a[4 * i + 2] = x.z;
        a[4 * i + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(
            bs + kk * BN + j * (BN / 2) + tx * 4);
        b[4 * j] = x.x;
        b[4 * j + 1] = x.y;
        b[4 * j + 2] = x.z;
        b[4 * j + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_a(As + (cur ^ 1) * BK * LDA);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // output (i, j) of this thread: row (i/4) * BM/2 + 4 ty + i%4, column
  // (j/4) * BN/2 + 4 tx + j%4
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
    if (r >= M) continue;
    float* dst = out + (int64_t)r * N;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int c = col0 + (j / 4) * (BN / 2) + tx * 4;
      if constexpr (VEC) {
        if (c < N)
          *reinterpret_cast<float4*>(dst + c) = make_float4(
              acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < N) dst[c + q] = acc[i][j + q];
      }
    }
  }
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// C = sum over z of ws[z], in slice order (n elements of type V a slice)
template <typename V>
__global__ void splitk_sum_kernel(const V* __restrict__ ws, V* __restrict__ c,
                                  int64_t n, int split) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V s = ws[i];
  for (int z = 1; z < split; ++z) s = add(s, ws[z * n + i]);
  c[i] = s;
}

// ---------------------------------------------------------------- launch

struct Args {
  const void* a;
  const void* b;
  void* c;
  float* ws;  // (split, M, N) fp32 partials when split > 1
  int m, n, k, split, k_slice, vec;
  cudaStream_t stream;
};

// above 48 KB a block's dynamic shared memory needs an opt-in; each
// launcher asks once per template (not a stream operation, so a CUDA
// graph may capture the launches)
template <typename F>
int smem_opt_in(F kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int BM, int BN, int BK, bool VEC>
int launch_f32_tiles(const Args& a) {
  constexpr int smem = f32_smem_bytes<BM, BN, BK>();
  auto kernel = gemm_f32_kernel<BM, BN, BK, VEC>;
  static const int opt_in = smem_opt_in(kernel, smem);
  if (opt_in) return opt_in;
  dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, a.split);
  kernel<<<grid, Micro<BM, BN>::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.a), static_cast<const float*>(a.b),
      a.split > 1 ? a.ws : static_cast<float*>(a.c), a.m, a.n, a.k,
      a.k_slice);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK>
int launch_f32(const Args& a) {
  const int err = a.vec ? launch_f32_tiles<BM, BN, BK, true>(a)
                        : launch_f32_tiles<BM, BN, BK, false>(a);
  if (err != 0 || a.split == 1) return err;
  const int64_t mn = (int64_t)a.m * a.n;
  if (mn % 4 == 0) {
    const unsigned blocks = static_cast<unsigned>((mn / 4 + 255) / 256);
    splitk_sum_kernel<float4><<<blocks, 256, 0, a.stream>>>(
        reinterpret_cast<const float4*>(a.ws), static_cast<float4*>(a.c),
        mn / 4, a.split);
  } else {
    const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
    splitk_sum_kernel<float><<<blocks, 256, 0, a.stream>>>(
        a.ws, static_cast<float*>(a.c), mn, a.split);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK>
int launch_loop(const Args& a) {
  typedef __nv_bfloat16 T;
  dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  gemm_loop_kernel<T, BM, BN, BK><<<grid, kLoopThreads, 0, a.stream>>>(
      static_cast<const T*>(a.a), static_cast<const T*>(a.b),
      static_cast<T*>(a.c), a.m, a.n, a.k);
  return static_cast<int>(cudaGetLastError());
}

template <bool F32, int BM, int BN>
int dispatch_bk(int bk, const Args& a) {
  switch (bk) {
    case 16: return F32 ? launch_f32<BM, BN, 16>(a) : launch_loop<BM, BN, 16>(a);
    case 32: return F32 ? launch_f32<BM, BN, 32>(a) : launch_loop<BM, BN, 32>(a);
  }
  return -1;
}

template <bool F32, int BM>
int dispatch_bn(int bn, int bk, const Args& a) {
  switch (bn) {
    case 32: return dispatch_bk<F32, BM, 32>(bk, a);
    case 64: return dispatch_bk<F32, BM, 64>(bk, a);
    case 128: return dispatch_bk<F32, BM, 128>(bk, a);
  }
  return -1;
}

template <bool F32>
int dispatch(int bm, int bn, int bk, const Args& a) {
  switch (bm) {
    case 16: return dispatch_bn<F32, 16>(bn, bk, a);
    case 32: return dispatch_bn<F32, 32>(bn, bk, a);
    case 64: return dispatch_bn<F32, 64>(bn, bk, a);
    case 128: return dispatch_bn<F32, 128>(bn, bk, a);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32 (split-K and vec as given; ws holds split * M * N
// floats when split > 1, and each slice but the last covers k_slice, a
// multiple of bk), 1 = bfloat16 (the loop: split must be 1).  Returns
// cudaGetLastError() after the launches (0 on success), or -1 when the
// arguments name no template.
extern "C" int repro_gemm(const void* a, const void* b, void* c, void* ws,
                          int m, int n, int k, int dtype, int bm, int bn,
                          int bk, int split, int k_slice, int vec,
                          void* stream) {
  if (split < 1 || k_slice < 1 || k_slice % bk != 0 ||
      (int64_t)k_slice * (split - 1) >= k || (split > 1 && ws == nullptr))
    return -1;
  const Args args{a, b, c, static_cast<float*>(ws), m, n, k, split,
                  k_slice, vec, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<true>(bm, bn, bk, args);
  if (dtype == 1 && split == 1) return dispatch<false>(bm, bn, bk, args);
  return -1;
}
