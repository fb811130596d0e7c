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
// Here one thread block owns one query tile (BQ rows of one head) and runs
// the whole KV loop itself.  The loop covers only the KV tiles the causal
// and window limits allow (the reference's block skip, as loop bounds),
// the running state lives in registers, tiles are read in place from the
// (B, S, H, D) layout with the S and D tails zero-filled, and masked
// columns get the reference's -1e30 score, so a fully masked tile behaves
// as in the reference and a fully masked row divides by 1.
//
// What bounds it on an H100: operations.  A causal prefill of S tokens
// does about 2 * HQ * S^2 * D flops against (2 HQ + 2 HKV) * S * D values
// moved; at S = 1024, D = 128 that is ~440 flop/byte, past the bf16
// tensor-core ridge (~295), so the kernel has to run on the tensor cores.
//
// Two kernels, one per dtype:
//
// bf16 (the serving path): flash_mma_kernel, on the tensor cores.  A block
// of BQ/16 warps owns BQ query rows, 16 rows a warp; grid (B*HQ, S/BQ) with
// the query tiles in reverse, so the longest causal tiles of every head
// start first and the last wave is short.  Q, K and V sit in shared memory
// as bf16, rows padded by 16 bytes so that ldmatrix is free of bank
// conflicts; K/V tiles stream through a two-stage cp.async ring (16-byte
// cp.async.cg, commit_group / wait_group): tile j+1 loads while tile j
// computes, and Q is loaded once and kept in registers as A fragments.
// S = Q K^T is mma.sync m16n8k16 bf16 -> fp32, K's rows being the .col B
// operand through ldmatrix.  The softmax works on the accumulator
// fragments: scores pre-scaled by scale * log2(e) so that the exponential
// is exp2f, masks applied only on the tiles that cross the causal
// diagonal, the window's lower edge or the S tail, row max and row sum by
// __shfl_xor_sync over the 4 lanes of a quad, m and l in fp32 registers.
// P is rounded to bf16 in registers and reused directly as the A fragment
// of O += P V (V through ldmatrix.trans); l sums the fp32 P.  The plain
// version (flash_attention_plain) rounds P the same way for bf16 inputs.
// The epilogue divides by l (1 where l == 0) and stores bf16 in place.
// 16-byte copies need D % 8 == 0 and 16-byte aligned rows; otherwise the
// wrapper passes vec = 0 and the tiles are filled by scalar loads.
//
// fp32: flash_ffma_kernel, the FFMA kernel of the first port, kept as it
// was.  fp32 must stay IEEE fp32 (the reference holds it to 1e-5 and the
// full-width LM gate to 1e-4), which the bf16 tensor cores cannot give,
// and only that gate and the fp32 checks launch it.  Per KV tile each of
// its 256 threads (a 16 x 16 grid) owns a (BQ/16) x (BK/16) block of
// scores; row max and row sum by shuffles across the 16 threads of a row;
// P goes through shared memory; exp is the accurate expf.  Q [BQ][DP+1],
// K [BK][DP+1], V [BK][DP] and P [BQ][BK+1] are fp32 in shared memory.
//
// Templates (the "run geometry"): BQ and BK in {16, 32, 64}, DP (head_dim
// padded up) in {16, 32, 64, 128}, for each dtype.  The Python wrapper
// (repro_torch/kernels/flash_attention.py::legalize) picks them, keeps the
// footprint under 100 KB (two blocks an SM), and computes the same shared
// memory sizes as ffma_smem_floats and mma_smem_bytes here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFfmaThreads = 256;  // a 16 x 16 thread grid over the tiles
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// the KV tiles a query tile starting at q0 can see (the reference's block
// skip; flash_attention.py::kv_tile_range)
__device__ __forceinline__ void kv_tiles(int q0, int bq, int bk, int S,
                                         int causal, int window, int& lo,
                                         int& hi) {
  hi = (S + bk - 1) / bk - 1;
  if (causal) hi = min(hi, (q0 + bq - 1) / bk);
  lo = 0;
  if (window > 0) {
    const int first = q0 - window + 2 - bk;  // least k0: k0+bk-1 >= q0-window+1
    if (first > 0) lo = (first + bk - 1) / bk;
  }
}

// ------------------------------------------------------------ fp32: FFMA

template <int BQ, int BK, int DP>
constexpr int ffma_smem_floats() {
  return BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1);
}

template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(kFfmaThreads)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int S, int HQ, int HKV, int D, float scale, int causal,
                  int window) {
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
  const float* qb = q + (int64_t)b * S * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  float* ob = o + (int64_t)b * S * q_stride + (int64_t)h * D;

  for (int e = tid; e < BQ * DP; e += kFfmaThreads) {
    const int r = e / DP, c = e % DP, s = q0 + r;
    Qs[r * (DP + 1) + c] =
        (s < S && c < D) ? qb[(int64_t)s * q_stride + c] : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int j_lo, j_hi;
  kv_tiles(q0, BQ, BK, S, causal, window, j_lo, j_hi);

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q is loaded; the last tile's K, V and P are read
    for (int e = tid; e < BK * DP; e += kFfmaThreads) {
      const int r = e / DP, c = e % DP, s = k0 + r;
      const bool in = s < S && c < D;
      Ks[r * (DP + 1) + c] = in ? kb[(int64_t)s * kv_stride + c] : 0.f;
      Vs[r * DP + c] = in ? vb[(int64_t)s * kv_stride + c] : 0.f;
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
        ob[(int64_t)row * q_stride + col] = acc[i][c] / denom;
    }
  }
}


// ------------------------------------------------- bf16: tensor cores

typedef __nv_bfloat16 bf16;

template <int BQ, int BK, int DP>
constexpr int mma_smem_bytes() {  // Q [BQ][DP+8], K and V [2][BK][DP+8]
  return (BQ + 4 * BK) * (DP + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS x DP tile of rows row0.. of a (S, stride) bf16 matrix into shared
// memory [ROWS][DP + 8]; rows >= S and columns >= D are zero.  vec: by
// 16-byte cp.async (the caller commits); else by scalar loads.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g,
                                          int64_t stride, int row0, int S,
                                          int D, bool vec, int tid) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (e >= ROWS * CH) break;
    const int r = e / CH, c = (e % CH) * 8, s = row0 + r;
    bf16* dst = sm + r * LD + c;
    if (vec) {
      const bool in = s < S && c < D;
      cp_async_16(smem_addr(dst), in ? g + (int64_t)s * stride + c : g, in);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        tmp[i] = (s < S && c + i < D) ? g[(int64_t)s * stride + c + i]
                                      : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(BQ * 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                 int HQ, int HKV, int D, float scale_log2, int causal,
                 int window, int vec) {
  constexpr int NT = BQ * 2;   // one warp per 16 query rows
  constexpr int LD = DP + 8;   // padded row: ldmatrix without bank conflicts
  constexpr int KD = DP / 16;  // k-steps of Q K^T
  constexpr int NS = BK / 8;   // n-tiles of S (8 KV columns each)
  constexpr int KV = BK / 16;  // k-steps of P V
  constexpr int ND = DP / 8;   // n-tiles of O (8 head columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                    // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // quad row, lane in the quad
  const int b = blockIdx.x / HQ;
  const int h = blockIdx.x % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int64_t q_stride = (int64_t)HQ * D;
  const int64_t kv_stride = (int64_t)HKV * D;
  const bf16* qb = q + (int64_t)b * S * q_stride + (int64_t)h * D;
  const bf16* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  bf16* ob = o + (int64_t)b * S * q_stride + (int64_t)h * D;

  int j_lo, j_hi;
  kv_tiles(q0, BQ, BK, S, causal, window, j_lo, j_hi);

  load_tile<BQ, DP, NT>(Qs, qb, q_stride, q0, S, D, vec, tid);
  cp_async_commit();
  load_tile<BK, DP, NT>(Ks, kb, kv_stride, j_lo * BK, S, D, vec, tid);
  load_tile<BK, DP, NT>(Vs, vb, kv_stride, j_lo * BK, S, D, vec, tid);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first K/V tile may still fly
  __syncthreads();

  uint32_t qa[KD][4];  // Q's A fragments, loaded once
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qa[kk], smem_addr(Qs + (warp * 16 + (lane & 15)) * LD +
                                  kk * 16 + (lane >> 4) * 8));
  float acc[ND][4];    // O: rows g and g + 8 of the warp, fp32
  float m[2] = {kNegInf, kNegInf};  // running max (log2 units), rows g, g+8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int r0 = q0 + warp * 16 + g;  // the two rows this lane holds
  const int r1 = r0 + 8;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) {  // the next tile streams in while this one computes
      const int nst = st ^ 1;
      load_tile<BK, DP, NT>(Ks + nst * BK * LD, kb, kv_stride, (j + 1) * BK,
                            S, D, vec, tid);
      load_tile<BK, DP, NT>(Vs + nst * BK * LD, vb, kv_stride, (j + 1) * BK,
                            S, D, vec, tid);
    }
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;

    // S = Q K^T: lanes 0-7 / 8-15 address the two d-halves of n-tile nj,
    // lanes 16-31 those of n-tile nj + 1
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nj = 0; nj < NS; nj += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(Kt + (nj * 8 + (lane & 7) + (lane >> 4) * 8)
                                           * LD + kk * 16 +
                                  ((lane >> 3) & 1) * 8));
        mma_bf16(sc[nj], qa[kk], kf[0], kf[1]);
        mma_bf16(sc[nj + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // online softmax on the fragments: element e of n-tile nj sits at row
    // (e < 2 ? r0 : r1), column k0 + nj * 8 + 2 * t4 + (e & 1)
    const int k0 = j * BK;
    const bool need_mask = k0 + BK > S ||
                           (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nj = 0; nj < NS; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nj][e] * scale_log2;
        if (need_mask) {
          const int row = e < 2 ? r0 : r1;
          const int col = k0 + nj * 8 + 2 * t4 + (e & 1);
          bool ok = col < S;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          if (!ok) x = kNegInf;
        }
        sc[nj][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nj = 0; nj < NS; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nj][e] - m[e >> 1]);
        sc[nj][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + ps[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the S fragments of n-tiles 2t, 2t+1, rounded to bf16, are
    // the A fragment of k-step t; lanes 0-15 address V rows t*16.. of
    // n-tile dn, lanes 16-31 those of n-tile dn + 1
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * t][0], sc[2 * t][1]),
                              pack_bf16(sc[2 * t][2], sc[2 * t][3]),
                              pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]),
                              pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(Vt + (t * 16 + (lane & 15)) * LD +
                                        dn * 8 + (lane >> 4) * 8));
        mma_bf16(acc[dn], pa, vf[0], vf[1]);
        mma_bf16(acc[dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is read before the next load refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (l[i] == 0.f) l[i] = 1.f;  // a fully masked row
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? r0 : r1;
    if (row >= S) continue;
    bf16* dst = ob + (int64_t)row * q_stride;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      const int col = dn * 8 + 2 * t4;
      const float x0 = acc[dn][2 * i] / l[i], x1 = acc[dn][2 * i + 1] / l[i];
      if (vec) {
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) dst[col] = __float2bfloat16(x0);
        if (col + 1 < D) dst[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, HQ, HKV, D;
  float scale;
  int causal, window, vec;
  cudaStream_t stream;
};

// above 48 KB a block's dynamic shared memory needs an opt-in; each
// launcher asks once per template (not a stream operation, so a CUDA
// graph may capture the launches)
template <typename K>
int smem_opt_in(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int BQ, int BK, int DP>
int launch_ffma(const Args& a) {
  constexpr int smem = ffma_smem_floats<BQ, BK, DP>() * (int)sizeof(float);
  auto kernel = flash_ffma_kernel<BQ, BK, DP>;
  static const int opt_in = smem_opt_in(kernel, smem);
  if (opt_in) return opt_in;
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.HQ);
  kernel<<<grid, kFfmaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.S, a.HQ,
      a.HKV, a.D, a.scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BK, int DP>
int launch_mma(const Args& a) {
  constexpr int smem = mma_smem_bytes<BQ, BK, DP>();
  auto kernel = flash_mma_kernel<BQ, BK, DP>;
  static const int opt_in = smem_opt_in(kernel, smem);
  if (opt_in) return opt_in;
  dim3 grid(a.B * a.HQ, (a.S + BQ - 1) / BQ);
  kernel<<<grid, BQ * 2, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.S, a.HQ,
      a.HKV, a.D, a.scale * kLog2e, a.causal, a.window, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool MMA, int BQ, int BK>
int dispatch_dp(int dp, const Args& a) {
  switch (dp) {
    case 16: return MMA ? launch_mma<BQ, BK, 16>(a) : launch_ffma<BQ, BK, 16>(a);
    case 32: return MMA ? launch_mma<BQ, BK, 32>(a) : launch_ffma<BQ, BK, 32>(a);
    case 64: return MMA ? launch_mma<BQ, BK, 64>(a) : launch_ffma<BQ, BK, 64>(a);
    case 128:
      return MMA ? launch_mma<BQ, BK, 128>(a) : launch_ffma<BQ, BK, 128>(a);
  }
  return -1;
}

template <bool MMA, int BQ>
int dispatch_bk(int bk, int dp, const Args& a) {
  switch (bk) {
    case 16: return dispatch_dp<MMA, BQ, 16>(dp, a);
    case 32: return dispatch_dp<MMA, BQ, 32>(dp, a);
    case 64: return dispatch_dp<MMA, BQ, 64>(dp, a);
  }
  return -1;
}

template <bool MMA>
int dispatch(int bq, int bk, int dp, const Args& a) {
  switch (bq) {
    case 16: return dispatch_bk<MMA, 16>(bk, dp, a);
    case 32: return dispatch_bk<MMA, 32>(bk, dp, a);
    case 64: return dispatch_bk<MMA, 64>(bk, dp, a);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32 (the FFMA kernel), 1 = bfloat16 (the tensor-core
// kernel).  window <= 0 means no window.  vec: 16-byte copies are legal
// (bf16 only).  Returns cudaGetLastError() after the launch (0 on
// success), or -1 when the arguments name no template or a shape it does
// not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int HQ, int HKV, int D, float scale,
                                     int causal, int window, int dtype,
                                     int bq, int bk, int dp, int vec,
                                     void* stream) {
  if (B < 1 || S < 1 || HKV < 1 || HQ % HKV != 0 || D < 1 || D > dp)
    return -1;
  const Args a{q, k, v, o, B, S, HQ, HKV, D, scale, causal, window, vec,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<false>(bq, bk, dp, a);
  if (dtype == 1) return dispatch<true>(bq, bk, dp, a);
  return -1;
}
