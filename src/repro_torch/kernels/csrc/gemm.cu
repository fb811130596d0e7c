// Tiled GEMM C = A @ B for Hopper (sm_90a), fp32 or bf16 inputs, fp32
// accumulation, output in fp32 or bf16 (the reference's out_dtype, A's
// dtype by default).  Row-major, contiguous operands: A (M, K), B (K, N),
// C (M, N).
//
// Replaces the TPU kernel repro/kernels/gemm.py::_gemm_kernel.  There the
// grid was (M/bm, N/bn, K/bk) run in order on one core, with an fp32 VMEM
// scratch accumulator carried across the sequential k axis and the inputs
// zero-padded to tile multiples; each step was one jnp.dot of bf16 (or
// fp32) tiles on the MXU with preferred_element_type=float32.  Here a
// thread block owns one (BM, BN) output tile and runs a K loop itself, in
// steps of BK, with the accumulator in registers; loads are masked at the
// M/N/K tails instead of padding, and the store is masked instead of
// slicing the padded result.  Two kernels, one per operand dtype.
//
// Split-K, shared by both.  The ARCO-tuned tile still sets the output
// tile, but where the tiles are fewer than the SMs (ResNet-18's deep
// layers get 16-49 tiles at batch 8) the wrapper
// (repro_torch/kernels/gemm.py::legalize) cuts K into split_k contiguous
// slices of whole BK steps, about two blocks an SM in all.  Each slice's
// block writes its fp32 partial tile to a workspace (split_k, M, N);
// splitk_sum_kernel then adds the slices in slice order and rounds each
// sum once to C's type.  No atomics: the result is deterministic.
//
// The output epilogue, shared by every store of C: each fp32 value v of C
// (row r, column c) becomes v + bias[c], then + residual[r, c], then
// relu(v) with NaN kept, each step only where the launch asks for it, as
// separate adds in that order (no FMA), and is rounded once to C's type.
// bias (N) and residual (M, N, contiguous) are of C's type.  A conv's
// bias, ReLU and a residual net's skip add thus cost no pass over the
// activations.  The arguments are runtime values, uniform over a launch,
// read only in the store: the tile kernels apply the epilogue where they
// write C, and write raw fp32 partials where they write the workspace, whose
// sum kernel then applies it after the sum.  A launch without one stores
// what the plain GEMM stores.
//
// bf16 (gemm_bf16_kernel): what the TPU kernel computes, bf16 tiles into
// an fp32 accumulator.  What bounds it on an H100: bytes.  The ResNet-18
// im2col products at batch 8 do 45-212 FLOP per byte of bf16 operands,
// below the 295 FLOP/byte ridge of the bf16 tensor cores (989 TFLOP/s)
// over 3.35 TB/s, so the kernel has to keep the memory system busy: many
// bytes in flight and every SM working.  Its design:
//
// - Tensor cores: mma.sync.m16n8k16 bf16 -> fp32.  A block of 2 to 8
//   warps (Warps<BM, BN>) tiles its output into warp tiles of 16 or 32
//   rows by 16, 32 or 64 columns; a warp's A fragments come through
//   ldmatrix and B's (row-major K x N, the .col operand) through
//   ldmatrix.trans, as flash_mma_kernel reads Q and V.
// - bf16 kept in shared memory: a tile row is padded by 8 bf16 (16
//   bytes), so the 8 rows an ldmatrix reads fall in 8 different 16-byte
//   bank groups: no conflicts.  Half the bytes of fp32 tiles.
// - A 3-stage cp.async ring (kStages): both operands by 16-byte
//   cp.async.cg (8 bf16, zero-filled past the tails) with commit_group /
//   wait_group, two steps in flight while one computes, one barrier a
//   step.  The 16-byte copies need K % 8 == 0 and N % 8 == 0 (rows on
//   16-byte boundaries) and 16-byte aligned bases; otherwise (conv1's K
//   147) the wrapper picks the scalar template (VEC false): each thread
//   loads its single A values of step t + 2, masked, into registers
//   before step t computes (all of them in flight at once) and stores
//   them into the ring after it; B's single values go straight into the
//   ring (conv1's B is 147 x 64, read by every block from L2).
// - Split-K as above; a block's tile goes to C directly (fp32 or bf16,
//   two adjacent columns a store where VEC) when K is not cut.
// - An implicit-GEMM mode (IMPLICIT, instantiated with VEC only) for a
//   conv: A is not a patch matrix in memory but gathered from the NHWC
//   activation x (batch, H, W, CI) as the ring loads it.  Row r of A is
//   the output pixel (n, oh, ow), r = (n * OH + oh) * OW + ow; column k
//   is (kh, kw, ci), k = (kh * KW + kw) * CI + ci, the order of the HWIO
//   filter's reshape (KH * KW * CI, CO), which is B.  A's 16-byte chunk
//   (r, k..k+7) is one cp.async.cg from x[n, oh * s + kh - p, ow * s + kw
//   - p, ci..ci+7]; a chunk in the padding, past M or past the slice is
//   zero-filled by the same src-size 0 as the tails, so no padded copy
//   of x is made.  CI % 8 == 0 keeps a chunk inside one (kh, kw), on
//   16-byte boundaries of x.  A thread's chunks share one column, so it
//   decomposes its rows into (n, oh, ow) once, before the K loop, and a
//   step only advances its (kh, kw, ci) by BK.  The tile it lands is the
//   patch matrix's tile, and the rest of the kernel is unchanged: the
//   product is bit-identical to im2col + the GEMM at the same geometry.
//
// It is mma.sync and not wgmma/TMA: wgmma takes 64-row tiles, and ARCO's
// 16- and 32-row templates do not give them; at these intensities the
// bytes, not the tensor cores, set the bound.
//
// fp32 (gemm_f32_kernel): bounded by the arithmetic.  The same products do
// 22 to 106 FLOP per byte of fp32 operands, above the 20 FLOP/byte ridge
// of the fp32 pipes (67 TFLOP/s, no TF32: the reference holds fp32 to rtol
// 1e-5) over 3.35 TB/s, so the kernel has to keep 132 SMs' FMA pipes busy.
// Beside split-K it has:
//
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
// It issues plain FFMA, not wgmma/TMA: fp32 must stay IEEE fp32.  It
// always writes fp32; for a bf16 C from fp32 operands its tiles go to the
// fp32 workspace even when K is not cut, and the sum kernel rounds each
// sum once to bf16.
//
// Tile templates (the "run geometry"): BM in {16, 32, 64, 128}, BN in
// {32, 64, 128}.  fp32: BK in {16, 32}, for each VEC (BM / TM) * (BN / TN)
// threads with TM = 8 at BM 128 (else 4) and TN = 8 at BN 128 (else 4),
// 32 to 256; dynamic shared memory 2 * BK * ((BM + 4) + BN) * 4 bytes, at
// most 66,560.  bf16: BK in {32, 64} (64 or 128 bytes a row), for each
// VEC, and the implicit mode beside VEC, 64 to 256 threads (a multiple of
// BK / 8: a thread's A chunks share one column); dynamic shared memory
// kStages * (BM * (BK + 8) + BK * (BN + 8)) * 2 bytes, at most 107,520
// (128 x 128 x 64), beside BN * 4 bytes of static shared memory for the
// epilogue's bias (at most 512, within the budget's margin).  A launch
// above 48 KB opts in once per template.  The wrapper maps a requested
// GemmConfig onto these templates: per dimension, the largest template
// not above min(requested block, problem size), else the smallest
// template.  It alone decides which templates run: bf16's BK is taken
// among those whose ring fits two blocks an SM at its BM x BN (so never
// 128 x 128 x 64), and the wrapper's RunGeometry.smem_bytes repeats
// bf16_smem_bytes and f32_smem_bytes below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

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

// ------------------------------------------------- the output epilogue

// what a launch adds to each value of C before its rounding: null where
// not given, relu 0 or 1 (see the top of the file)
struct Epilogue {
  const void* bias;      // (N) of C's type
  const void* residual;  // (M, N) of C's type, contiguous
  int relu;
};

// element i of an epilogue operand, bf16 where bf (else fp32), as fp32,
// through the read-only path
__device__ __forceinline__ float load_epi(const void* p, int64_t i, bool bf) {
  if (bf)
    return __bfloat162float(__ushort_as_bfloat16(
        __ldg(static_cast<const unsigned short*>(p) + i)));
  return __ldg(static_cast<const float*>(p) + i);
}

// v through the launch's epilogue, given its column's bias b and its
// residual res (each read only where the launch gave it)
__device__ __forceinline__ float epilogue(const Epilogue& e, float v, float b,
                                          float res) {
  if (e.bias) v = __fadd_rn(v, b);
  if (e.residual) v = __fadd_rn(v, res);
  if (e.relu)  // max.NaN: NaN stays NaN, as F.relu keeps it
    asm("max.NaN.f32 %0, %0, 0f00000000;" : "+f"(v));
  return v;
}

// ------------------------------------------- bf16: tensor cores

constexpr int kStages = 3;  // the cp.async ring: two steps in flight

// the warp grid over a (BM, BN) tile: warp tiles of WM (16 or 32) rows by
// WN (16, 32 or 64) columns; 4 warps, 8 at BM 128, 2 at 16 x 32
template <int BM, int BN>
struct Warps {
  static constexpr int M = BM == 16 ? 1 : (BM == 128 ? 4 : 2);
  static constexpr int N = BM == 16 ? (BN >= 64 ? 4 : 2) : 2;
  static constexpr int WM = BM / M;
  static constexpr int WN = BN / N;
  static constexpr int THREADS = 32 * M * N;
};

template <int BM, int BN, int BK>
constexpr int bf16_smem_bytes() {  // the ring of A [BM][BK+8], B [BK][BN+8]
  return kStages * (BM * (BK + 8) + BK * (BN + 8)) * 2;
}

// the conv whose patch matrix the implicit mode gathers as A: x is NHWC
// (batch, h, w, ci), the output (batch, oh, ow, co), the filter kh x kw
struct Conv {
  int h, w, ci, oh, ow, kw, stride, pad;
};

// One (BM, BN) tile of C, or of slice blockIdx.z's fp32 partial in the
// workspace, over K range [z * k_slice, min(K, (z + 1) * k_slice)).  C is
// bf16 when out_bf16, else fp32 (always fp32 for the workspace, whose
// launch passes no epilogue).  Where IMPLICIT, A is the activation x of
// `cv` (read only then).
template <int BM, int BN, int BK, bool VEC, bool IMPLICIT>
__global__ void __launch_bounds__(Warps<BM, BN>::THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 void* __restrict__ C, int M, int N, int K, int k_slice,
                 int out_bf16, Conv cv, Epilogue epi) {
  static_assert(VEC || !IMPLICIT, "the implicit mode gathers 16 bytes");
  using W = Warps<BM, BN>;
  constexpr int NT = W::THREADS;
  constexpr int LDA = BK + 8, LDB = BN + 8;  // padded rows (16 bytes)
  constexpr int MI = W::WM / 16;             // m16 tiles of a warp
  constexpr int NI = W::WN / 8;              // n8 tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [kStages][BM][LDA]
  bf16* Bs = As + kStages * BM * LDA;            // [kStages][BK][LDB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / W::N, wn = warp % W::N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_slice;
  const int ke = min(K, kb + k_slice);
  const int n_steps = (ke - kb + BK - 1) / BK;

  // the epilogue's bias over the tile's columns (0 past N), staged before
  // the K loop, whose barriers publish it to the store
  __shared__ __align__(16) float bias_s[BN];
  if (epi.bias)
    for (int c = tid; c < BN; c += NT)
      bias_s[c] = col0 + c < N ? load_epi(epi.bias, col0 + c, out_bf16) : 0.f;

  // IMPLICIT: chunk i of a step is A's row (tid + i * NT) / (BK / 8) and
  // column ac (the same for all of a thread's chunks, as NT is a multiple
  // of BK / 8); each row's pixel, before the K loop: the index in x's
  // (batch * h * w) pixels of the filter's top left tap, which may lie in
  // the padding (px_h, px_w: that tap's row and column; rows past M never
  // fall in x).  32-bit, three registers a chunk: the element offset is
  // widened at the load
  constexpr int ACH = BM * BK / 8, AI = (ACH + NT - 1) / NT;
  static_assert(NT % (BK / 8) == 0, "a thread's chunks share a column");
  const int ac = (tid % (BK / 8)) * 8;
  int px[IMPLICIT ? AI : 1], px_h[IMPLICIT ? AI : 1], px_w[IMPLICIT ? AI : 1];
  int tap_h = 0, tap_w = 0, tap_c = 0;  // (kh, kw, ci) of the next load's k
  if constexpr (IMPLICIT) {
#pragma unroll
    for (int i = 0; i < AI; ++i) {
      const int r = row0 + (tid + i * NT) / (BK / 8);
      const int n = r / (cv.oh * cv.ow), p = r - n * (cv.oh * cv.ow);
      const int oh = p / cv.ow, ow = p - oh * cv.ow;
      px_h[i] = r < M ? oh * cv.stride - cv.pad : -(1 << 29);
      px_w[i] = ow * cv.stride - cv.pad;
      px[i] = r < M ? (n * cv.h + px_h[i]) * cv.w + px_w[i] : 0;
    }
    const int k = kb + ac, kt = k / cv.ci;
    tap_c = k - kt * cv.ci;
    tap_h = kt / cv.kw;
    tap_w = kt - tap_h * cv.kw;
  }

  // step t's tiles into ring slot `slot`, zeros past M, N and the slice:
  // VEC both by cp.async; else B by single values (A: fetch and put)
  auto load = [&](int t, int slot) {
    const int k0 = kb + t * BK;
    bf16* as = As + slot * BM * LDA;
    bf16* bs = Bs + slot * BK * LDB;
    if constexpr (VEC) {  // 16-byte chunks: whole chunks in or out
      const bool k_in = k0 + ac < ke;
      const int tap = tap_h * cv.w + tap_w;  // IMPLICIT: this step's pixel
#pragma unroll
      for (int i = 0; i < AI; ++i) {
        const int e = tid + i * NT, r = e / (BK / 8);
        if (ACH % NT == 0 || e < ACH) {
          bool in;
          const bf16* src;
          if constexpr (IMPLICIT) {
            in = k_in && (unsigned)(px_h[i] + tap_h) < (unsigned)cv.h &&
                 (unsigned)(px_w[i] + tap_w) < (unsigned)cv.w;
            src = A + (int64_t)(px[i] + tap) * cv.ci + tap_c;
          } else {
            in = k_in && row0 + r < M;
            src = A + (int64_t)(row0 + r) * K + k0 + ac;
          }
          cp_async_16(smem_addr(as + r * LDA + ac), in ? src : A, in);
        }
      }
      if constexpr (IMPLICIT) {  // steps load in order: the next one's tap
        for (tap_c += BK; tap_c >= cv.ci; tap_c -= cv.ci)
          if (++tap_w == cv.kw) {
            tap_w = 0;
            ++tap_h;
          }
      }
      constexpr int BCH = BK * BN / 8;
#pragma unroll
      for (int i = 0; i < (BCH + NT - 1) / NT; ++i) {
        const int e = tid + i * NT;
        if (BCH % NT == 0 || e < BCH) {
          const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
          const bool in = k0 + r < ke && col0 + c < N;
          cp_async_16(smem_addr(bs + r * LDB + c),
                      in ? B + (int64_t)(k0 + r) * N + col0 + c : B, in);
        }
      }
    } else {  // consecutive threads along a row
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int r = e / BN, c = e % BN;
        bs[r * LDB + c] = (k0 + r < ke && col0 + c < N)
                              ? B[(int64_t)(k0 + r) * N + col0 + c]
                              : __float2bfloat16(0.f);
      }
    }
  };
  // !VEC: A (conv1's 147-value rows) by single values, consecutive
  // threads along a row, staged in registers (fetch) while a step
  // computes and stored after it (put): all of a step's A loads in flight
  // at once
  constexpr int AE = (BM * BK + NT - 1) / NT;
  bf16 ra[AE];  // unused (and dropped) where VEC
  auto fetch = [&](int t) {
    const int k0 = kb + t * BK;
#pragma unroll
    for (int i = 0; i < AE; ++i) {
      const int e = tid + i * NT, r = e / BK, c = e % BK;
      ra[i] = (e < BM * BK && row0 + r < M && k0 + c < ke)
                  ? A[(int64_t)(row0 + r) * K + k0 + c]
                  : __float2bfloat16(0.f);
    }
  };
  auto put = [&](int slot) {
    bf16* as = As + slot * BM * LDA;
#pragma unroll
    for (int i = 0; i < AE; ++i) {
      const int e = tid + i * NT;
      if ((BM * BK) % NT == 0 || e < BM * BK)
        as[(e / BK) * LDA + e % BK] = ra[i];
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // the ring's first steps
    if (s < n_steps) {
      load(s, s);
      if constexpr (!VEC) {
        fetch(s);
        put(s);
      }
    }
    cp_async_commit();  // possibly empty: one group a step
  }
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();  // step t has landed
    // ... and every warp is done with step t - 1, whose slot refills now
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < n_steps) {
      load(next, next % kStages);
      if constexpr (!VEC) fetch(next);
    }
    cp_async_commit();
    const bf16* as = As + (t % kStages) * BM * LDA + wm * W::WM * LDA;
    const bf16* bs = Bs + (t % kStages) * BK * LDB + wn * W::WN;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: lanes 0-15 address rows 0-15 at k 0-7, lanes 16-31 at k 8-15
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], smem_addr(as + (i * 16 + (lane & 15)) * LDA +
                                     kk * 16 + (lane >> 4) * 8));
      // B: lanes 0-15 address k rows 0-15 of n-tile j, lanes 16-31 those
      // of n-tile j + 1; .trans makes each the .col operand
      uint32_t bfr[NI][2];
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(bs + (kk * 16 + (lane & 15)) * LDB +
                                       j * 8 + (lane >> 4) * 8));
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    if constexpr (!VEC) {
      if (next < n_steps) put(next % kStages);
    }
  }
  cp_async_wait<0>();

  // fragment (i, j): rows r and r + 8 (e = 0, 1 and e = 2, 3), columns
  // c and c + 1, with r = g + 16 i and c = 2 t4 + 8 j in the warp tile
  const int g = lane / 4, t4 = lane % 4;
  const int64_t base = (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * W::WM + i * 16 + g + h * 8;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = col0 + wn * W::WN + j * 8 + 2 * t4;
        const int64_t rc = (int64_t)r * N + c, off = base + rc;
        float b0 = 0.f, b1 = 0.f, r0 = 0.f, r1 = 0.f;
        if (epi.bias) {
          const float2 b = *reinterpret_cast<const float2*>(bias_s + c - col0);
          b0 = b.x;
          b1 = b.y;
        }
        if (epi.residual) {
          if (c < N) r0 = load_epi(epi.residual, rc, out_bf16);
          if (c + 1 < N) r1 = load_epi(epi.residual, rc + 1, out_bf16);
        }
        const float v0 = epilogue(epi, acc[i][j][2 * h], b0, r0);
        const float v1 = epilogue(epi, acc[i][j][2 * h + 1], b1, r1);
        if (out_bf16) {
          bf16* dst = static_cast<bf16*>(C) + off;
          if (VEC) {  // N % 8 == 0: c and c + 1 are in or out together
            if (c < N)
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < N) dst[0] = __float2bfloat16(v0);
            if (c + 1 < N) dst[1] = __float2bfloat16(v1);
          }
        } else {
          float* dst = static_cast<float*>(C) + off;
          if (VEC) {
            if (c < N) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (c < N) dst[0] = v0;
            if (c + 1 < N) dst[1] = v1;
          }
        }
      }
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

// One (BM, BN) tile of C, or of slice blockIdx.z's partial in the
// workspace, over K range [z * k_slice, min(K, (z + 1) * k_slice)); the
// epilogue where it writes C (the workspace's launch passes none).
template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(Micro<BM, BN>::THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K, int k_slice,
                Epilogue epi) {
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

  // the epilogue in place on this thread's outputs (i, j), row (i/4) *
  // BM/2 + 4 ty + i%4 and column (j/4) * BN/2 + 4 tx + j%4, each column's
  // bias loaded once; then the store of C
  if (epi.bias || epi.residual || epi.relu) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + (j / 4) * (BN / 2) + tx * 4 + j % 4;
      const float b =
          epi.bias && c < N ? load_epi(epi.bias, c, false) : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = row0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
        const float res =
            epi.residual && r < M && c < N
                ? load_epi(epi.residual, (int64_t)r * N + c, false)
                : 0.f;
        acc[i][j] = epilogue(epi, acc[i][j], b, res);
      }
    }
  }
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

// four bf16 outputs, the store of one float4 sum
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ void cast_out(float v, float* o) { *o = v; }
__device__ __forceinline__ void cast_out(float4 v, float4* o) { *o = v; }
__device__ __forceinline__ void cast_out(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}
__device__ __forceinline__ void cast_out(float4 v, bf16x4* o) {
  *o = bf16x4{__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
}

// whether a store of type O writes bf16
template <typename O> constexpr bool kBf16 = false;
template <> constexpr bool kBf16<bf16> = true;
template <> constexpr bool kBf16<bf16x4> = true;

// the column of element i of a C with `cols` columns (a 32-bit division
// where i allows it)
__device__ __forceinline__ int column(int64_t i, int cols) {
  return i <= UINT32_MAX ? (int)((uint32_t)i % (uint32_t)cols)
                         : (int)(i % cols);
}

// the epilogue on element i, in column c, of a C of type bf16 where bf
__device__ __forceinline__ float finish_at(const Epilogue& e, float s,
                                           int64_t i, int c, bool bf) {
  return epilogue(e, s, e.bias ? load_epi(e.bias, c, bf) : 0.f,
                  e.residual ? load_epi(e.residual, i, bf) : 0.f);
}
// ... on sum i of a C with `cols` columns: element i where V is float
__device__ __forceinline__ float finish(const Epilogue& e, float s, int64_t i,
                                        int cols, bool bf) {
  return finish_at(e, s, i, e.bias ? column(i, cols) : 0, bf);
}
// ... elements 4i .. 4i + 3 where V is float4, each with its own column
// (M * N % 4 == 0 does not make N % 4 == 0)
__device__ __forceinline__ float4 finish(const Epilogue& e, float4 s,
                                         int64_t i, int cols, bool bf) {
  int c[4] = {0, 0, 0, 0};
  if (e.bias) {
    c[0] = column(4 * i, cols);
    for (int q = 1; q < 4; ++q) c[q] = c[q - 1] + 1 == cols ? 0 : c[q - 1] + 1;
  }
  return make_float4(finish_at(e, s.x, 4 * i, c[0], bf),
                     finish_at(e, s.y, 4 * i + 1, c[1], bf),
                     finish_at(e, s.z, 4 * i + 2, c[2], bf),
                     finish_at(e, s.w, 4 * i + 3, c[3], bf));
}

// C = sum over z of ws[z], in slice order (n elements of type V a slice),
// each sum through the epilogue and rounded once to C's type O
template <typename V, typename O>
__global__ void splitk_sum_kernel(const V* __restrict__ ws, O* __restrict__ c,
                                  int64_t n, int split, int cols,
                                  Epilogue epi) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V s = ws[i];
  for (int z = 1; z < split; ++z) s = add(s, ws[z * n + i]);
  cast_out(finish(epi, s, i, cols, kBf16<O>), c + i);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void* a;  // A, or the implicit mode's x
  const void* b;
  void* c;
  float* ws;  // (split, M, N) fp32 partials: split > 1, or fp32 -> bf16
  int m, n, k, split, k_slice, vec;
  bool out_bf16;  // C in bf16 (else fp32)
  cudaStream_t stream;
  bool implicit;  // bf16, vec: A gathered from the conv's x
  Conv conv;
  Epilogue epi;  // applied where C is written
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
  const bool to_ws = a.split > 1 || a.out_bf16;
  kernel<<<grid, Micro<BM, BN>::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.a), static_cast<const float*>(a.b),
      to_ws ? a.ws : static_cast<float*>(a.c), a.m, a.n, a.k, a.k_slice,
      to_ws ? Epilogue{} : a.epi);
  return static_cast<int>(cudaGetLastError());
}

// the sum of the workspace's slices into C of type O: 4 elements a thread
// where M * N allows it (V = float4, O4 the 4-wide store of O), else 1
template <typename O, typename O4>
void launch_sum(const Args& a) {
  const int64_t mn = (int64_t)a.m * a.n;
  if (mn % 4 == 0) {
    const unsigned blocks = static_cast<unsigned>((mn / 4 + 255) / 256);
    splitk_sum_kernel<float4, O4><<<blocks, 256, 0, a.stream>>>(
        reinterpret_cast<const float4*>(a.ws), static_cast<O4*>(a.c),
        mn / 4, a.split, a.n, a.epi);
  } else {
    const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
    splitk_sum_kernel<float, O><<<blocks, 256, 0, a.stream>>>(
        a.ws, static_cast<O*>(a.c), mn, a.split, a.n, a.epi);
  }
}

template <int BM, int BN, int BK>
int launch_f32(const Args& a) {
  const int err = a.vec ? launch_f32_tiles<BM, BN, BK, true>(a)
                        : launch_f32_tiles<BM, BN, BK, false>(a);
  if (err != 0 || (a.split == 1 && !a.out_bf16)) return err;
  if (a.out_bf16)
    launch_sum<__nv_bfloat16, bf16x4>(a);
  else
    launch_sum<float, float4>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, bool VEC, bool IMPLICIT>
int launch_bf16_tiles(const Args& a) {
  constexpr int smem = bf16_smem_bytes<BM, BN, BK>();
  auto kernel = gemm_bf16_kernel<BM, BN, BK, VEC, IMPLICIT>;
  static const int opt_in = smem_opt_in(kernel, smem);
  if (opt_in) return opt_in;
  dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, a.split);
  const bool to_ws = a.split > 1;
  kernel<<<grid, Warps<BM, BN>::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.a), static_cast<const bf16*>(a.b),
      to_ws ? static_cast<void*>(a.ws) : a.c, a.m, a.n, a.k, a.k_slice,
      !to_ws && a.out_bf16, a.conv, to_ws ? Epilogue{} : a.epi);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK>
int launch_bf16(const Args& a) {
  const int err = a.implicit ? launch_bf16_tiles<BM, BN, BK, true, true>(a)
                  : a.vec    ? launch_bf16_tiles<BM, BN, BK, true, false>(a)
                             : launch_bf16_tiles<BM, BN, BK, false, false>(a);
  if (err != 0 || a.split == 1) return err;
  if (a.out_bf16)
    launch_sum<__nv_bfloat16, bf16x4>(a);
  else
    launch_sum<float, float4>(a);
  return static_cast<int>(cudaGetLastError());
}

// BK: fp32 16 or 32, bf16 32 or 64
template <bool F32, int BM, int BN>
int dispatch_bk(int bk, const Args& a) {
  if constexpr (F32) {
    switch (bk) {
      case 16: return launch_f32<BM, BN, 16>(a);
      case 32: return launch_f32<BM, BN, 32>(a);
    }
  } else {
    switch (bk) {
      case 32: return launch_bf16<BM, BN, 32>(a);
      case 64: return launch_bf16<BM, BN, 64>(a);
    }
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

// the slices a launch is given cover K, none empty, each whole bk steps
bool bad_slices(int64_t k, int bk, int split, int k_slice) {
  return split < 1 || k_slice < 1 || k_slice % bk != 0 ||
         (int64_t)k_slice * (split - 1) >= k;
}

}  // namespace

// dtype (the operands') and out_dtype (C's): 0 = float32, 1 = bfloat16.
// Split-K and vec as given; each slice but the last covers k_slice, a
// multiple of bk; ws holds split * M * N floats when split > 1, or when
// fp32 operands write a bf16 C.  bias (n) and residual (m, n,
// contiguous), both of C's type, may be null, relu 0 or 1: the epilogue
// at the top of the file.  Returns cudaGetLastError() after the launches
// (0 on success), or -1 when the arguments name no template.
extern "C" int repro_gemm(const void* a, const void* b, void* c, void* ws,
                          int m, int n, int k, int dtype, int out_dtype,
                          int bm, int bn, int bk, int split, int k_slice,
                          int vec, const void* bias, const void* residual,
                          int relu, void* stream) {
  if (bad_slices(k, bk, split, k_slice) || (out_dtype != 0 && out_dtype != 1))
    return -1;
  if ((split > 1 || (dtype == 0 && out_dtype == 1)) && ws == nullptr)
    return -1;
  const Args args{a, b, c, static_cast<float*>(ws), m, n, k, split,
                  k_slice, vec, out_dtype == 1,
                  static_cast<cudaStream_t>(stream), false, Conv{},
                  Epilogue{bias, residual, relu != 0}};
  if (dtype == 0) return dispatch<true>(bm, bn, bk, args);
  if (dtype == 1) return dispatch<false>(bm, bn, bk, args);
  return -1;
}

// The conv x (batch, h, w, ci) NHWC by the filter f (kh, kw, ci, co) HWIO
// into C (batch * oh * ow, co), bf16 operands, by the bf16 kernel's
// implicit mode: the GEMM (M, N, K) = (batch * oh * ow, co, kh * kw * ci)
// with A gathered from x.  ci % 8 == 0, co % 8 == 0 and 16-byte aligned x
// and f (the VEC copies), x's pixels (batch * h * w) within int32 (the
// kernel's pixel index); the rest, the epilogue too, as repro_gemm (C is
// (batch * oh * ow, co), the residual of its shape).  Returns -1 where
// these do not hold.
extern "C" int repro_gemm_conv(const void* x, const void* f, void* c,
                               void* ws, int batch, int h, int w, int ci,
                               int co, int kh, int kw, int stride, int pad,
                               int out_dtype, int bm, int bn, int bk,
                               int split, int k_slice, const void* bias,
                               const void* residual, int relu,
                               void* stream) {
  if (stride < 1 || pad < 0 || batch < 1) return -1;
  const int oh = (h + 2 * pad - kh) / stride + 1;
  const int ow = (w + 2 * pad - kw) / stride + 1;
  const int64_t m = (int64_t)batch * oh * ow, k = (int64_t)kh * kw * ci;
  if (ci % 8 != 0 || co % 8 != 0 || oh < 1 || ow < 1 || m > INT32_MAX ||
      (int64_t)batch * h * w > INT32_MAX ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(f)) % 16 ||
      bad_slices(k, bk, split, k_slice) || (out_dtype != 0 && out_dtype != 1) ||
      (split > 1 && ws == nullptr))
    return -1;
  const Args args{x, f, c, static_cast<float*>(ws), (int)m, co, (int)k,
                  split, k_slice, 1, out_dtype == 1,
                  static_cast<cudaStream_t>(stream), true,
                  Conv{h, w, ci, oh, ow, kw, stride, pad},
                  Epilogue{bias, residual, relu != 0}};
  return dispatch<false>(bm, bn, bk, args);
}
