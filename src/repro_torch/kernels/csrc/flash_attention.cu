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
// tensor-core ridge (~295) and far past the fp32 FMA pipes' (~20).
//
// Both kernels share one shape: grid (B*HQ, S/BQ) with the query tiles in
// reverse, so the longest causal tiles of every head start first and the
// last wave is short (fp32 may also split the KV range, below); Q is
// loaded once a block; K/V tiles stream through
// a two-stage cp.async ring (commit_group / wait_group), tile j+1 loading
// while tile j computes; scores are pre-scaled by scale * log2(e) so that
// the exponential is exp2f; masks are applied only on the tiles that cross
// the causal diagonal, the window's lower edge or the S tail.
//
// bf16 (the serving path): flash_mma_kernel, on the tensor cores.  A block
// of BQ/16 warps owns BQ query rows, 16 rows a warp.  Q, K and V sit in
// shared memory as bf16, rows padded by 16 bytes so that ldmatrix is free
// of bank conflicts; 16-byte cp.async.cg copies; Q is kept in registers
// as A fragments.  S = Q K^T is mma.sync m16n8k16 bf16 -> fp32, K's rows
// being the .col B operand through ldmatrix.  The softmax works on the
// accumulator fragments, row max and row sum by __shfl_xor_sync over the
// 4 lanes of a quad, m and l in fp32 registers.  P is rounded to bf16 in
// registers and reused directly as the A fragment of O += P V (V through
// ldmatrix.trans); l sums the fp32 P.  The plain version
// (flash_attention_plain) rounds P the same way for bf16 inputs.  The
// epilogue divides by l (1 where l == 0) and stores bf16 in place.
// 16-byte copies need D % 8 == 0 and 16-byte aligned rows; otherwise the
// wrapper passes vec = 0 and the tiles are filled by scalar loads.
//
// fp32: flash_f32_kernel, on the FFMA pipes.  fp32 must stay IEEE fp32
// (the reference holds it to 1e-5, the full-width LM gates to 1e-4): every
// product and sum is an fmaf or an add in fp32, with no TF32 and no
// tensor-core instruction, so its bound is the 67 TFLOP/s of the FMA
// pipes.  Its design, after gemm.cu's gemm_f32_kernel:
//
// - A register microtile.  A block of 2 * BQ threads (BQ/16 warps) is a
//   grid of BQ/4 row groups by 8 threads; thread (ty, tx) owns query rows
//   ty + (BQ/4) i (i < 4), the score columns tx + 8 c (c < BK/8) and the
//   output columns 4 tx + 32 g .. + 3 (g < DP/32).  Q K^T steps through
//   head_dim 4 at a time: 4 float4 reads of Q and BK/8 of K give 16 BK/8
//   FFMAs (64 at BK 32); P V steps through the tile's keys: one float4 of
//   P and DP/32 float4s of V give 4 DP/8 FFMAs (64 at DP 128).  Both
//   loops are unrolled by 4: unrolled whole, a tile's code (some 4,500
//   instructions) ran slower on the card.
// - Conflict-free shared memory.  Q [BQ][DP+4] and K [BK][DP+4] rows are
//   padded by 4 floats: the 4 rows a warp reads of Q, and the 8 of K, fall
//   in distinct 16-byte bank groups.  A warp reads 8 consecutive float4s of
//   a V row.  P goes through shared memory transposed, P^T [BK][BQ+4],
//   the 4 rows of a thread in one float4; each warp writes and reads only
//   its own rows' slots, so a __syncwarp orders them.
// - The ring: 16-byte cp.async.cg where D % 4 == 0 and q, k and v start on
//   16-byte boundaries (the wrapper's vec), else 4-byte cp.async.ca;
//   branch-free copies from per-thread offsets; one __syncthreads a tile.
// - The row max and the row sum over the 8 threads of a row by
//   __shfl_xor_sync; each thread keeps its part of l and the 8 are summed
//   once, in the epilogue.
// - A KV split for grids under one wave.  A causal prefill with few heads
//   (qwen2's 12 at S ~1,000: ~190 blocks for 264 slots) ends with its
//   longest query tiles' KV loops running alone on a few SMs.  There the
//   wrapper (kv_split) cuts each query tile's KV range into runs of
//   kv_chunk tiles: grid (splits * B * HQ, S/BQ), a tile's runs side by
//   side; a run writes its unnormalised rows and their m and l to a
//   workspace, and flash_f32_combine_kernel merges the runs of each row,
//   in order (the plain version merges the same runs the same way).  The
//   wrapper counts the pair as one launch.
//
// Templates (the "run geometry").  bf16: BQ and BK in {16, 32, 64}, DP
// (head_dim padded up) in {16, 32, 64, 128, 192} (192: MLA's 128 + 64
// keys), the 42 that fit the wrapper's shared-memory budget compiled (at
// DP 192 only BK 16 and 32).  fp32: the
// 17 (BQ, BK, DP) of dispatch_f32 below, BQ and BK in {16, 32, 64}, DP in
// {32, 64, 128}, those whose shared memory lets an SM hold at least 8
// warps.  The Python wrapper (repro_torch/kernels/flash_attention.py::
// legalize) alone picks the template, by the same sizes as mma_smem_bytes
// and f32_smem_bytes here; a test holds dispatch_f32's list to the set
// legalize can pick.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ fp32: FFMA

constexpr int kRowThreads = 8;  // fp32: the threads that share a row group
constexpr int kRows = 4;        // fp32: query rows a thread
constexpr int kUnroll = 4;      // fp32: head_dim steps (and keys) unrolled

template <int BQ, int BK, int DP>
constexpr int f32_smem_bytes() {  // Q [BQ][DP+4], K [2][BK][DP+4],
  return 4 * (BQ * (DP + 4) + 2 * BK * (DP + 4)  // V [2][BK][DP],
              + 2 * BK * DP + BK * (BQ + 4));    // P^T [BK][BQ+4]
}

// ROWS x DP fp32 tile of rows row0.. of a (S, stride) matrix into shared
// memory rows of LD floats; rows >= S and columns >= D are zero-filled
// (the copy reads nothing there).  vec: 16-byte cp.async.cg, each thread
// on one column chunk of rows r, r + NT/(DP/4), ...; else 4-byte
// cp.async.ca.  Branch-free: a thread's offsets are fixed, a copy's
// predicate only sets its source size.  The caller commits.
template <int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void load_f32_tile(float* sm, const float* g,
                                              int64_t stride, int row0,
                                              int S, int D, bool vec,
                                              int tid) {
  if (vec) {
    constexpr int CH = DP / 4;   // 16-byte chunks a row
    constexpr int RS = NT / CH;  // rows a pass
    static_assert(NT % CH == 0 && ROWS % RS == 0, "fp32 tile copy");
    const int r = tid / CH, c = (tid % CH) * 4;
    const bool col_in = c < D;
    const uint32_t dst = smem_addr(sm + r * LD + c);
    const float* src = g + (int64_t)(row0 + r) * stride + c;
#pragma unroll
    for (int i = 0; i < ROWS / RS; ++i) {
      const bool in = col_in && row0 + r + i * RS < S;
      cp_async_16(dst + i * RS * LD * 4, in ? src + i * RS * stride : g,
                  in);
    }
  } else {
    static_assert(ROWS * DP % NT == 0, "fp32 tile copy");
#pragma unroll 4
    for (int i = 0; i < ROWS * DP / NT; ++i) {
      const int e = tid + i * NT, r = e / DP, c = e % DP;
      const bool in = c < D && row0 + r < S;
      cp_async_4(smem_addr(sm + r * LD + c),
                 in ? g + (int64_t)(row0 + r) * stride + c : g, in);
    }
  }
}

template <int BQ>
constexpr int f32_threads() { return BQ / kRows * kRowThreads; }

// 2 * BQ threads; at least 8 warps an SM by registers (255 a thread)
template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(f32_threads<BQ>(),
                                  256 / f32_threads<BQ>())
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int HQ, int HKV, int D, float scale_log2, int causal,
                 int window, int vec, int kv_chunk, int splits,
                 float* __restrict__ part_o, float* __restrict__ part_ml) {
  constexpr int R = kRows;
  constexpr int TX = kRowThreads;
  constexpr int TY = BQ / R;        // row groups
  constexpr int NT = TY * TX;       // 2 * BQ
  constexpr int LD = DP + 4;        // Q and K rows, padded
  constexpr int LP = BQ + 4;        // P^T rows, padded
  constexpr int CK = BK / TX;       // score columns a thread
  constexpr int G = DP / (4 * TX);  // float4 groups of output columns
  static_assert(TY % 4 == 0 && BK % TX == 0 && DP % (4 * TX) == 0,
                "fp32 flash tile");
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;          // [BQ][LD]
  float* Ks = Qs + BQ * LD;      // [2][BK][LD]
  float* Vs = Ks + 2 * BK * LD;  // [2][BK][DP]
  float* Ps = Vs + 2 * BK * DP;  // [BK][LP]: row ty + TY i in slot 4 ty + i

  // grid (splits * B * HQ, S / BQ): a query tile's runs side by side, the
  // query tiles in reverse, so the longest causal tiles of every head and
  // all their runs start first and the last wave is short
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = bh / HQ;
  const int h = bh % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t q_stride = (int64_t)HQ * D;
  const int64_t kv_stride = (int64_t)HKV * D;
  const float* qb = q + (int64_t)b * S * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  float* ob = o + (int64_t)b * S * q_stride + (int64_t)h * D;

  int j_lo, j_hi;
  kv_tiles(q0, BQ, BK, S, causal, window, j_lo, j_hi);
  if (kv_chunk > 0) {  // this block's run of the KV range, if it has one
    j_lo += split * kv_chunk;
    if (j_lo > j_hi) return;
    j_hi = min(j_hi, j_lo + kv_chunk - 1);
  }

  load_f32_tile<BQ, DP, LD, NT>(Qs, qb, q_stride, q0, S, D, vec, tid);
  load_f32_tile<BK, DP, LD, NT>(Ks, kb, kv_stride, j_lo * BK, S, D, vec,
                                tid);
  load_f32_tile<BK, DP, DP, NT>(Vs, vb, kv_stride, j_lo * BK, S, D, vec,
                                tid);
  cp_async_commit();

  float acc[R][4 * G];  // O: rows ty + TY i, columns 4 tx + 32 g + e
  float m[R], l[R];     // running max (log2 units); this thread's part of l
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * G; ++e) acc[i][e] = 0.f;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's stage is read
    if (j < j_hi) {   // the next tile streams in while this one computes
      load_f32_tile<BK, DP, LD, NT>(Ks + (st ^ 1) * BK * LD, kb, kv_stride,
                                    (j + 1) * BK, S, D, vec, tid);
      load_f32_tile<BK, DP, DP, NT>(Vs + (st ^ 1) * BK * DP, vb, kv_stride,
                                    (j + 1) * BK, S, D, vec, tid);
      cp_async_commit();
    }
    const float* Kt = Ks + st * BK * LD;
    const float* Vt = Vs + st * BK * DP;

    // S = Q K^T, 4 of head_dim a step (the zero-filled tail adds 0)
    float sc[R][CK];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) sc[i][c] = 0.f;
#pragma unroll kUnroll
    for (int d = 0; d < DP; d += 4) {
      float4 qf[R], kf[CK];
#pragma unroll
      for (int i = 0; i < R; ++i)
        qf[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * LD + d);
#pragma unroll
      for (int c = 0; c < CK; ++c)
        kf[c] = *reinterpret_cast<const float4*>(Kt + (tx + TX * c) * LD + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          sc[i][c] = fmaf(qf[i].x, kf[c].x, sc[i][c]);
          sc[i][c] = fmaf(qf[i].y, kf[c].y, sc[i][c]);
          sc[i][c] = fmaf(qf[i].z, kf[c].z, sc[i][c]);
          sc[i][c] = fmaf(qf[i].w, kf[c].w, sc[i][c]);
        }
    }

    // online softmax: score (i, c) sits at row q0 + ty + TY i, column
    // k0 + tx + TX c
    const int k0 = j * BK;
    const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float x = sc[i][c] * scale_log2;
        if (need_mask) {
          const int col = k0 + tx + TX * c;
          bool ok = col < S;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          if (!ok) x = kNegInf;
        }
        sc[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = exp2f(sc[i][c] - m_new);
        sc[i][c] = p;
        ps += p;
      }
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int e = 0; e < 4 * G; ++e) acc[i][e] *= alpha;
    }

    // P^T into this warp's slots: column tx + TX c, rows 4 ty .. 4 ty + 3
#pragma unroll
    for (int c = 0; c < CK; ++c)
      *reinterpret_cast<float4*>(Ps + (tx + TX * c) * LP + R * ty) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    __syncwarp();

    // O += P V, one key of the tile a step
#pragma unroll kUnroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + kk * LP +
                                                         R * ty);
      const float p[R] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            Vt + kk * DP + 4 * tx + 4 * TX * g);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][4 * g] = fmaf(p[i], x.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p[i], x.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], x.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], x.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

  // a split's rows go to the workspace unnormalised, with their m and l
  // (flash_f32_combine_kernel merges them); else O = acc / l
  const int64_t part_row = ((int64_t)split * (gridDim.x / splits) + bh) * S;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + ty + TY * i;
    if (kv_chunk > 0 && tx == 0 && row < S) {
      part_ml[2 * (part_row + row)] = m[i];
      part_ml[2 * (part_row + row) + 1] = l[i];
    }
    if (kv_chunk > 0) l[i] = 1.f;
    else if (l[i] == 0.f) l[i] = 1.f;  // a fully masked row
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    float* dst = kv_chunk > 0 ? part_o + (part_row + row) * D
                              : ob + (int64_t)row * q_stride;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = 4 * tx + 4 * TX * g;
      const float x0 = acc[i][4 * g] / l[i], x1 = acc[i][4 * g + 1] / l[i];
      const float x2 = acc[i][4 * g + 2] / l[i];
      const float x3 = acc[i][4 * g + 3] / l[i];
      if (vec) {
        if (col < D)
          *reinterpret_cast<float4*>(dst + col) = make_float4(x0, x1, x2, x3);
      } else {
        if (col < D) dst[col] = x0;
        if (col + 1 < D) dst[col + 1] = x1;
        if (col + 2 < D) dst[col + 2] = x2;
        if (col + 3 < D) dst[col + 3] = x3;
      }
    }
  }
}

// The KV split's second pass: one warp a query row of one head, over the
// splits that hold it (the same kv_tiles bounds, cut by kv_chunk):
// M = max m_z, O = sum_z 2^(m_z - M) acc_z / sum_z 2^(m_z - M) l_z (1
// where the sum is 0), in split order; m is in log2 units.
__global__ void __launch_bounds__(128)
flash_f32_combine_kernel(const float* __restrict__ part_o,
                         const float* __restrict__ part_ml,
                         float* __restrict__ o, int B, int S, int HQ, int D,
                         int bq, int bk, int causal, int window,
                         int kv_chunk) {
  const int64_t rows = (int64_t)B * HQ * S;
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const int row = static_cast<int>(w % S);
  const int64_t bh = w / S;
  int lo, hi;
  kv_tiles(row / bq * bq, bq, bk, S, causal, window, lo, hi);
  const int n = (hi - lo + kv_chunk) / kv_chunk;  // splits with this row
  float M = kNegInf;
  for (int z = 0; z < n; ++z) M = fmaxf(M, part_ml[2 * (z * rows + w)]);
  float L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};  // columns lane + 32 e
  for (int z = 0; z < n; ++z) {
    const float wz = exp2f(part_ml[2 * (z * rows + w)] - M);
    L += wz * part_ml[2 * (z * rows + w) + 1];
    const float* src = part_o + (z * rows + w) * D;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (lane + 32 * e < D) acc[e] += wz * src[lane + 32 * e];
  }
  if (L == 0.f) L = 1.f;  // a fully masked row
  float* dst = o + ((bh / HQ) * S + row) * (int64_t)HQ * D + (bh % HQ) * D;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (lane + 32 * e < D) dst[lane + 32 * e] = acc[e] / L;
}

// ------------------------------------------------- bf16: tensor cores

typedef __nv_bfloat16 bf16;

template <int BQ, int BK, int DP>
constexpr int mma_smem_bytes() {  // Q [BQ][DP+8], K and V [2][BK][DP+8]
  return (BQ + 4 * BK) * (DP + 8) * 2;
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
  int kv_chunk;     // fp32: KV tiles a run of the split; 0: no split
  int splits;       // the most runs any query tile's KV range makes
  float* part_o;    // fp32 split workspace: [splits][B*HQ][S][D]
  float* part_ml;   // and [splits][B*HQ][S][2] (m, l)
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
int launch_f32(const Args& a) {
  constexpr int smem = f32_smem_bytes<BQ, BK, DP>();
  auto kernel = flash_f32_kernel<BQ, BK, DP>;
  static const int opt_in = smem_opt_in(kernel, smem);
  if (opt_in) return opt_in;
  const int splits = a.kv_chunk > 0 ? a.splits : 1;
  dim3 grid(splits * a.B * a.HQ, (a.S + BQ - 1) / BQ);
  kernel<<<grid, f32_threads<BQ>(), smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.S, a.HQ,
      a.HKV, a.D, a.scale * kLog2e, a.causal, a.window, a.vec, a.kv_chunk,
      splits, a.part_o, a.part_ml);
  if (a.kv_chunk <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t rows = (int64_t)a.B * a.HQ * a.S;
  flash_f32_combine_kernel<<<(rows + 3) / 4, 128, 0, a.stream>>>(
      a.part_o, a.part_ml, static_cast<float*>(a.o), a.B, a.S, a.HQ, a.D, BQ,
      BK, a.causal, a.window, a.kv_chunk);
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

// the fp32 templates: exactly those legalize can pick
// (flash_attention.py::f32_templates; tests/test_torch_attention.py holds
// this list to it)
int dispatch_f32(int bq, int bk, int dp, const Args& a) {
#define F32(BQ, BK, DP) \
  if (bq == BQ && bk == BK && dp == DP) return launch_f32<BQ, BK, DP>(a)
  F32(64, 32, 128); F32(64, 16, 128); F32(32, 16, 128);
  F32(64, 64, 64);  F32(64, 32, 64);  F32(64, 16, 64);
  F32(32, 32, 64);  F32(32, 16, 64);  F32(16, 16, 64);
  F32(64, 64, 32);  F32(64, 32, 32);  F32(64, 16, 32);
  F32(32, 64, 32);  F32(32, 32, 32);  F32(32, 16, 32);
  F32(16, 32, 32);  F32(16, 16, 32);
#undef F32
  return -1;
}

template <int BQ, int BK>
int dispatch_mma_dp(int dp, const Args& a) {
  switch (dp) {
    case 16: return launch_mma<BQ, BK, 16>(a);
    case 32: return launch_mma<BQ, BK, 32>(a);
    case 64: return launch_mma<BQ, BK, 64>(a);
    case 128: return launch_mma<BQ, BK, 128>(a);
    case 192:
      // BK 64 at DP 192 is past SMEM_BUDGET: legalize never picks it
      if constexpr (BK <= 32) return launch_mma<BQ, BK, 192>(a);
      return -1;
  }
  return -1;
}

template <int BQ>
int dispatch_mma_bk(int bk, int dp, const Args& a) {
  switch (bk) {
    case 16: return dispatch_mma_dp<BQ, 16>(dp, a);
    case 32: return dispatch_mma_dp<BQ, 32>(dp, a);
    case 64: return dispatch_mma_dp<BQ, 64>(dp, a);
  }
  return -1;
}

int dispatch_mma(int bq, int bk, int dp, const Args& a) {
  switch (bq) {
    case 16: return dispatch_mma_bk<16>(bk, dp, a);
    case 32: return dispatch_mma_bk<32>(bk, dp, a);
    case 64: return dispatch_mma_bk<64>(bk, dp, a);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32 (the FFMA kernel), 1 = bfloat16 (the tensor-core
// kernel).  window <= 0 means no window.  vec: 16-byte copies are legal
// (head_dim a whole number of 16-byte chunks, q, k and v on 16-byte
// boundaries).  kv_chunk > 0 (fp32 only): each query tile's KV range is
// cut into runs of kv_chunk tiles (splits at most), one block each, into
// the caller's workspace part_o and part_ml, and a second kernel merges
// them.  Returns cudaGetLastError() after the launch (0 on
// success), or -1 when the arguments name no template or a shape it does
// not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int HQ, int HKV, int D, float scale,
                                     int causal, int window, int dtype,
                                     int bq, int bk, int dp, int vec,
                                     int kv_chunk, int splits, void* part_o,
                                     void* part_ml, void* stream) {
  if (B < 1 || S < 1 || HKV < 1 || HQ % HKV != 0 || D < 1 || D > dp ||
      (kv_chunk > 0 && (dtype != 0 || splits < 1 || !part_o || !part_ml)))
    return -1;
  const Args a{q, k, v, o, B, S, HQ, HKV, D, scale, causal, window, vec,
               kv_chunk, splits, static_cast<float*>(part_o),
               static_cast<float*>(part_ml),
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_f32(bq, bk, dp, a);
  if (dtype == 1) return dispatch_mma(bq, bk, dp, a);
  return -1;
}
