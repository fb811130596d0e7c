// MLA decode attention on the latent cache (DeepSeek-V3's absorbed form),
// one query token a sequence, bf16 on the tensor cores.
//
// For each sequence b and head h (H = 16 or 32: one or two m16 tiles of
// query rows):
//   s_j = q[b, h, :] . [ckv[b, j, :] | kpe[b, j, :]] * scale, j < len[b]
//   out[b, h, :] = sum_j softmax(s)_j ckv[b, j, :]
// q (B, H, 576) is the absorbed query q_nope W_UK (512) beside the roped
// (or, under NoPE, unrotated) q_pe (64); ckv (B, C, 512) and kpe (B, C,
// 64) are the cache (C its positions, rows contiguous); out (B, H, 512).
// The cache is read once: a tile of BK positions lands in shared memory
// ([ckv | kpe] a row, by 16-byte cp.async, two stages), S = Q K^T runs
// on mma.sync m16n8k16 with fp32 sums, the online softmax keeps an fp32
// running max and sum (log2 units), and P (rounded to bf16, as the flash
// kernel rounds it) times the tile's ckv part accumulates in fp32.  Four warps a block: each
// computes the whole 16 x BK S (the K tile is shared; the products are
// few beside the bytes) and a quarter of the 512 output columns.
//
// Heads: a block takes one group of 16 heads, the groups of a sequence
// side by side on the grid's x axis (block x = b * H / 16 + group), so
// that at H = 32 the two blocks of a sequence read its tiles together,
// the second mostly from L2.  At H = 16 block x is b: the launch and
// every block's work are those of a kernel built for 16 heads alone.
//
// KV split: a sequence's T tiles (of its own length) go to its gridDim.y
// blocks in runs of ceil(T / gridDim.y): block (b, z) walks tiles
// [z * chunk, (z + 1) * chunk).  The grid is sized for the longest
// sequence (or the cache's capacity, where a caller has no host length);
// each sequence's blocks share its own length evenly, so a short one does
// not leave blocks idle beside a long one's.  With one split a block
// writes out; with more it writes its unnormalised rows and their (m, l)
// to a workspace, and mla_decode_combine_kernel merges the splits of each
// row (a split past its sequence's end writes l = 0 and counts for
// nothing).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeads = 16;            // query rows a block: one m16 tile
constexpr int kLat = 512;             // kv_lora_rank
constexpr int kRope = 64;             // qk_rope_head_dim
constexpr int kQK = kLat + kRope;     // 576
constexpr int kLD = kQK + 8;          // padded smem row: no bank conflicts
constexpr int kBK = 32;               // cache positions a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = kLat / kWarps;  // output columns a warp: 128
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmem = (kHeads + 2 * kBK) * kLD * 2;   // 93,440 bytes

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

// cache rows s0.. s0 + kBK - 1 of one sequence into a stage [kBK][kLD]:
// 64 chunks of ckv then 8 of kpe a row; rows >= len zero
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* ckv,
                                          const bf16* kpe, int s0, int len,
                                          int tid) {
  constexpr int CH = kQK / 8;  // 72 chunks a row
#pragma unroll
  for (int i = 0; i < kBK * CH / kThreads; ++i) {
    const int e = tid + i * kThreads, r = e / CH, c = e % CH, s = s0 + r;
    const bool in = s < len;
    const bf16* src = c < kLat / 8 ? ckv + (int64_t)s * kLat + c * 8
                                   : kpe + (int64_t)s * kRope + (c - kLat / 8) * 8;
    cp_async_16(smem_addr(sm + r * kLD + c * 8), in ? src : ckv, in);
  }
}

__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ckv,
                  const bf16* __restrict__ kpe, const int* __restrict__ lens,
                  bf16* __restrict__ out, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int C, int groups,
                  float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [16][kLD]
  bf16* Ks = Qs + kHeads * kLD;                   // [2][kBK][kLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // blk: this block's 16 query rows; b: their sequence; B: blocks a split
  const int blk = blockIdx.x, z = blockIdx.y, B = gridDim.x;
  const int b = blk / groups;
  const int len = lens[b];
  const int tiles = (len + kBK - 1) / kBK;
  const int kv_chunk = (tiles + gridDim.y - 1) / gridDim.y;
  const int t_lo = z * kv_chunk, t_hi = min(tiles, t_lo + kv_chunk) - 1;
  const bf16* cb = ckv + (int64_t)b * C * kLat;
  const bf16* pb = kpe + (int64_t)b * C * kRope;

  float m[2] = {kNegInf, kNegInf};  // running max (log2 units), rows g, g+8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  float acc[kCols / 8][4];          // O: rows g, g + 8, this warp's columns
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (t_lo <= t_hi) {
    const bf16* qb = q + (int64_t)blk * kHeads * kQK;
    constexpr int QCH = kQK / 8;
#pragma unroll
    for (int i = 0; i < kHeads * QCH / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e / QCH, c = e % QCH;
      cp_async_16(smem_addr(Qs + r * kLD + c * 8), qb + r * kQK + c * 8,
                  true);
    }
    cp_async_commit();
    load_tile(Ks, cb, pb, t_lo * kBK, len, tid);
    cp_async_commit();

    for (int t = t_lo; t <= t_hi; ++t) {
      const int st = (t - t_lo) & 1;
      if (t < t_hi)  // the next tile streams in while this one computes
        load_tile(Ks + (st ^ 1) * kBK * kLD, cb, pb, (t + 1) * kBK, len, tid);
      cp_async_commit();  // possibly empty: keeps one group per tile
      cp_async_wait<1>();  // Q and tile t have landed
      __syncthreads();
      const bf16* Kt = Ks + st * kBK * kLD;

      // S = Q K^T over the 576 columns
      float sc[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kQK / 16; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, smem_addr(Qs + (lane & 15) * kLD + kk * 16 +
                                  (lane >> 4) * 8));
#pragma unroll
        for (int nj = 0; nj < kBK / 8; nj += 2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(Kt + (nj * 8 + (lane & 7) +
                                          (lane >> 4) * 8) * kLD +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(sc[nj], qa, kf[0], kf[1]);
          mma_bf16(sc[nj + 1], qa, kf[2], kf[3]);
        }
      }

      // online softmax: element e of n-tile nj is row (e < 2 ? g : g + 8),
      // position t * kBK + nj * 8 + 2 * t4 + (e & 1)
      const int k0 = t * kBK;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nj = 0; nj < kBK / 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nj][e] * scale_log2;
          if (k0 + nj * 8 + 2 * t4 + (e & 1) >= len) x = kNegInf;
          sc[nj][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
      for (int nj = 0; nj < kBK / 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[nj][e] - m[e >> 1]);
          sc[nj][e] = p;
          ps[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + ps[i];
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V, V the tile's ckv part, this warp's columns
#pragma unroll
      for (int tt = 0; tt < kBK / 16; ++tt) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * tt][0], sc[2 * tt][1]),
                                pack_bf16(sc[2 * tt][2], sc[2 * tt][3]),
                                pack_bf16(sc[2 * tt + 1][0], sc[2 * tt + 1][1]),
                                pack_bf16(sc[2 * tt + 1][2], sc[2 * tt + 1][3])};
#pragma unroll
        for (int dn = 0; dn < kCols / 8; dn += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_addr(Kt + (tt * 16 + (lane & 15)) * kLD +
                                          warp * kCols + dn * 8 +
                                          (lane >> 4) * 8));
          mma_bf16(acc[dn], pa, vf[0], vf[1]);
          mma_bf16(acc[dn + 1], pa, vf[2], vf[3]);
        }
      }
      __syncthreads();  // this stage is read before the next load refills it
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = g + 8 * i;
    const int64_t row = (int64_t)blk * kHeads + h;
    if (split) {
      float* dst = part_o + ((int64_t)z * B * kHeads + row) * kLat;
#pragma unroll
      for (int dn = 0; dn < kCols / 8; ++dn) {
        const int col = warp * kCols + dn * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[dn][2 * i], acc[dn][2 * i + 1]);
      }
      if (warp == 0 && t4 == 0) {
        float* ml = part_ml + ((int64_t)z * B * kHeads + row) * 2;
        ml[0] = m[i];
        ml[1] = l[i];
      }
    } else {
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      bf16* dst = out + row * kLat;
#pragma unroll
      for (int dn = 0; dn < kCols / 8; ++dn) {
        const int col = warp * kCols + dn * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
      }
    }
  }
}

// merges the splits of each (b, h) row: weights exp2(m_z - max m), the
// splits with l = 0 left out; 128 threads, 4 columns each
__global__ void __launch_bounds__(128)
mla_decode_combine_kernel(const float* __restrict__ part_o,
                          const float* __restrict__ part_ml,
                          bf16* __restrict__ out, int rows, int splits) {
  const int64_t row = blockIdx.x;
  float top = kNegInf;
  for (int z = 0; z < splits; ++z) {
    const float* ml = part_ml + ((int64_t)z * rows + row) * 2;
    if (ml[1] > 0.f) top = fmaxf(top, ml[0]);
  }
  float L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int col = threadIdx.x * 4;
  for (int z = 0; z < splits; ++z) {
    const float* ml = part_ml + ((int64_t)z * rows + row) * 2;
    if (!(ml[1] > 0.f)) continue;
    const float w = exp2f(ml[0] - top);
    L += w * ml[1];
    const float4 o = *reinterpret_cast<const float4*>(
        part_o + ((int64_t)z * rows + row) * kLat + col);
    acc[0] += w * o.x;
    acc[1] += w * o.y;
    acc[2] += w * o.z;
    acc[3] += w * o.w;
  }
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  bf16* dst = out + row * kLat + col;
  dst[0] = __float2bfloat16(acc[0] * inv);
  dst[1] = __float2bfloat16(acc[1] * inv);
  dst[2] = __float2bfloat16(acc[2] * inv);
  dst[3] = __float2bfloat16(acc[3] * inv);
}

}  // namespace

// q (B, H, 576), ckv (B, C, 512), kpe (B, C, 64), out (B, H, 512): bf16,
// contiguous, 16-byte aligned; H 16 or 32; lens (B,) int32 in [1, C].
// splits > 1 needs the workspaces part_o (splits, B, H, 512) and part_ml
// (splits, B, H, 2), fp32.  Returns cudaGetLastError() after the launches, or -1 for
// arguments it does not take.
extern "C" int repro_mla_decode(const void* q, const void* ckv,
                                const void* kpe, const void* lens, void* out,
                                int B, int H, int C, float scale,
                                int splits, void* part_o,
                                void* part_ml, void* stream) {
  if (B < 1 || (H != kHeads && H != 2 * kHeads) || C < 1 || splits < 1 ||
      (splits > 1 && (!part_o || !part_ml)))
    return -1;
  const int groups = H / kHeads;
  static const int opt_in = static_cast<int>(cudaFuncSetAttribute(
      mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
  if (opt_in) return opt_in;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mla_decode_kernel<<<dim3(B * groups, splits), kThreads, kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ckv),
      static_cast<const bf16*>(kpe), static_cast<const int*>(lens),
      static_cast<bf16*>(out), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), C, groups, scale * kLog2e);
  if (splits > 1)
    mla_decode_combine_kernel<<<B * H, 128, 0, s>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
        static_cast<bf16*>(out), B * H, splits);
  return static_cast<int>(cudaGetLastError());
}
