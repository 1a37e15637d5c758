// Wide-head attention forward for NVIDIA Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU splash kernel (`_splash_attention` /
// `_splash_kernel`, lanpaint_tpu/models/layers.py:103-173) where the VAEs'
// mid attention reaches it: one head over the latent grid, D = 512 in the
// image VAE (lanpaint_tpu/models/vae.py:81; S = 16,384 at 1024^2), D = 384
// and 640 in the Wan2.1 and Wan2.2 video VAEs (lanpaint_tpu/models/
// video_vae.py:159; one launch over the B*T frames, S = 3,520 a frame at
// 704x1280 for Wan2.2, 6,240 at 480x832 for Wan2.1).  It computes
// non-causal softmax(Q K^T * scale) V with fp32 softmax and accumulation.
//
// What bounds it on this card: compute.  A call does 4 * B * S^2 * D flops
// (550 GFLOP at S = 16,384, D = 512) and reads each K/V tile once per
// query block, far above the H100's ~295 flop/byte ridge.
//
// Why a design of its own: the D <= 128 kernel (attention.cu) keeps a
// warp's whole output row block, acc[D/8][4] fp32, in registers; at D = 512
// that is 256 registers a thread before Q's fragments.  Here the output's D
// is split across warps instead, in slices of 128 columns:
//   * one block of kGroups x D/128 warps per (batch, head, 16*kGroups-query
//     tile): warp w owns query rows 16*(w % kGroups) .. +16 and the D slice
//     128*(w / kGroups) .. +128, so its accumulator is acc[16][4] (64
//     registers), as the D = 128 kernel's;
//   * per 32-key tile, each warp computes the partial scores of its 16 rows
//     over its D slice (mma.sync m16n8k16 bf16, fp32 accumulate); the D/128
//     partials of a row group meet in shared memory and every warp of the
//     group sums them in the same order (slice 0, 1, ...), so all of them
//     hold bit-identical scores and run the same online softmax (running
//     max and sum in registers, exp2 with the scale folded into log2 units)
//     with no further exchange; then P V on the warp's D slice.  Q K^T is
//     computed once (no per-slice recomputation), so the flops are those of
//     one pass;
//   * Q (16*kGroups x D) stays in shared memory for the whole block; K and V
//     tiles stream through a two-stage ring filled by cp.async (16-byte
//     copies, the next tile in flight while this one is computed), V read
//     row-major through ldmatrix.trans (no transposed copy); the partial
//     scores reuse the current K buffer once every warp is done reading it;
//   * q/k/v are read in the JAX layout (B, S, H, D) through element strides
//     (the video VAE hands over column slices of one fused q|k|v
//     projection), rows past S are zero-filled by the copy and keys past S
//     are masked to -inf, which replaces the TPU path's segment-id padding.
// The row groups a block holds are chosen per D so that the warps' registers
// (at most 65,536 / threads each) and the shared memory, (16*kGroups + 4*32)
// rows of D + 8 bf16, stay within one SM:
//   D = 384: 4 groups x 3 slices = 12 warps, 150,528 bytes;
//   D = 512: 4 groups x 4 slices = 16 warps, 199,680 bytes (the 128-register
//            cap of a 512-thread block);
//   D = 640: 2 groups x 5 slices = 10 warps, 207,360 bytes (4 groups would
//            need 248,832, above the 232,448 a block may have).
// All are above the 48 KB default (cudaFuncSetAttribute), one block an SM.
// No TMA or wgmma yet.
//
// Interface: a plain C function (ctypes), launching on the caller's stream
// and returning cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 32;    // keys per tile
constexpr int kSliceD = 128;   // D columns per warp
constexpr int kPad = 8;        // bf16 elements of padding per shared-memory row
constexpr int kVec = 8;        // bf16 elements per 16-byte copy

// The block shape for head dim D with kGroups row groups of 16 queries.
template <int D, int kGroups>
struct WideShape {
  static_assert(D % kSliceD == 0, "D must be a multiple of 128");
  static constexpr int kSlices = D / kSliceD;
  static constexpr int kWarps = kGroups * kSlices;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBlockM = 16 * kGroups;  // query rows per block
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory is addressed with 32-bit byte addresses (one register each,
// where a generic pointer takes two): the kernel sits at the 128-register
// cap of a 512-thread block (D = 512).
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// 16-byte global -> shared copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices, transposed on load: lanes 8i..8i+7 address the
// rows of matrix i, and r[i] receives this lane's mma B fragment of it.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, int kGroups>
struct WideSmem {
  static constexpr int kLd = D + kPad;               // row stride of every tile, in bf16
  static constexpr int kRowBytes = 2 * kLd;
  static constexpr int kTileBytes = kBlockN * kRowBytes;  // one K or V tile
  // Q, K ring, V ring
  static constexpr int kRows = WideShape<D, kGroups>::kBlockM + 2 * kBlockN + 2 * kBlockN;
  static constexpr size_t kBytes = size_t(kRows) * kRowBytes;
  static_assert(kBytes <= 232448, "above the shared memory a block may have");
};

// Copies of `rows` rows of D bf16 from `src` (row stride `ld` elements) to
// shared memory at `dst`; rows at or past `valid_rows` are zero-filled.
template <int D, int kGroups, int kRowsCopied>
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, long long ld,
                                          int valid_rows, int tid) {
  constexpr int kThreads = WideShape<D, kGroups>::kThreads;
  constexpr int kVecPerRow = D / kVec;
  static_assert(kRowsCopied * kVecPerRow % kThreads == 0, "whole 16-byte copies per thread");
#pragma unroll 1
  for (int it = 0; it < kRowsCopied * kVecPerRow / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * kVec;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * WideSmem<D, kGroups>::kRowBytes + 2 * c, src + (ok ? r * ld : 0) + c,
               ok);
  }
}

template <int D, int kGroups>
__global__ void __launch_bounds__(WideShape<D, kGroups>::kThreads, 1)
wide_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                     long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                     float scale_log2) {
  using Sm = WideSmem<D, kGroups>;
  using Sh = WideShape<D, kGroups>;
  constexpr int kBlockM = Sh::kBlockM;
  // the partial scores (every warp's 16 rows x kBlockN fp32) fit in one K tile
  static_assert(sizeof(float) * Sh::kWarps * 16 * kBlockN <= Sm::kTileBytes,
                "partial scores do not fit in a K tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sK0 = sQ + kBlockM * Sm::kRowBytes;  // K ring: 2 tiles
  const uint32_t sV0 = sK0 + 2 * Sm::kTileBytes;      // V ring: 2 tiles

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int rg = warp % kGroups;  // this warp's 16 query rows: 16 * rg ..
  const int dq = warp / kGroups;  // this warp's D slice: kSliceD * dq ..
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // Q tile and the first K/V tile, as one group.
  copy_rows<D, kGroups, kBlockM>(sQ, q + b * q_sb + h * q_sh + m0 * q_ss, q_ss, S - m0, tid);
  copy_rows<D, kGroups, kBlockN>(sK0, kb, k_ss, S, tid);
  copy_rows<D, kGroups, kBlockN>(sV0, vb, v_ss, S, tid);
  cp_async_commit();

  float acc[kSliceD / 8][4];
#pragma unroll
  for (int j = 0; j < kSliceD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max (log2 units) and partial sum for rows g and g + 8
  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};

  // this lane's A-fragment address (Q), B-fragment offset within a K tile,
  // ldmatrix row offset within a V tile, and partial-score slot
  const uint32_t q_frag = sQ + (rg * 16 + g) * Sm::kRowBytes + 2 * (dq * kSliceD + t4 * 2);
  const uint32_t k_frag = g * Sm::kRowBytes + 2 * (dq * kSliceD + t4 * 2);
  const int mat = lane >> 3;
  const uint32_t v_frag =
      ((mat & 1) * 8 + (lane & 7)) * Sm::kRowBytes + 2 * (dq * kSliceD + (mat >> 1) * 8);
  const uint32_t part_w = 4 * (warp * 16 * 32 + lane);  // + 4 * 32 * (nt * 4 + e)
  // + 4 * 32 * (qd * kGroups * 16 + nt * 4 + e)
  const uint32_t part_r = 4 * (rg * 16 * 32 + lane);

  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kBlockN;
    const uint32_t slot = (t & 1) * Sm::kTileBytes;
    cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();      // everyone's have; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {  // the next tile streams in while this one is computed
      const uint32_t next = Sm::kTileBytes - slot;
      copy_rows<D, kGroups, kBlockN>(sK0 + next, kb + (n0 + kBlockN) * k_ss, k_ss,
                                     S - n0 - kBlockN, tid);
      copy_rows<D, kGroups, kBlockN>(sV0 + next, vb + (n0 + kBlockN) * v_ss, v_ss,
                                     S - n0 - kBlockN, tid);
      cp_async_commit();
    }
    const uint32_t sK = sK0 + slot;

    // Partial scores: 16 rows x 32 keys over this warp's D slice.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kSliceD / 16; ++kk) {
      const uint32_t pq = q_frag + 32 * kk;
      const uint32_t qa[4] = {lds_u32(pq), lds_u32(pq + 8 * Sm::kRowBytes), lds_u32(pq + 16),
                              lds_u32(pq + 8 * Sm::kRowBytes + 16)};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const uint32_t pk = sK + k_frag + nt * 8 * Sm::kRowBytes + 32 * kk;
        mma_16816(s[nt], qa, lds_u32(pk), lds_u32(pk + 16));
      }
    }

    // The D/128 partials of a row group meet in the K tile (no longer read),
    // in fragment order: part[warp][nt * 4 + e][lane].
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sts_f32(sK + part_w + 128 * (nt * 4 + e), s[nt][e]);
    __syncthreads();
    // Every warp of the group sums the same partials in the same order.
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 1
    for (int qd = 0; qd < Sh::kSlices; ++qd) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] += lds_f32(sK + part_r + 128 * (qd * kGroups * 16 + nt * 4 + e));
    }

    // Scale into log2 units, mask keys past S, update the running max.
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + nt * 8 + t4 * 2 + (e & 1);
        const float val = key < S ? s[nt][e] * scale_log2 : -CUDART_INF_F;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one valid key, so mx is finite here
      alpha[r] = exp2f(row_max[r] - mx[r]);
      row_max[r] = mx[r];
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mx[e >> 1]);
        s[nt][e] = p;
        tile_sum[e >> 1] += p;
      }
    }
    row_sum[0] = row_sum[0] * alpha[0] + tile_sum[0];
    row_sum[1] = row_sum[1] * alpha[1] + tile_sum[1];
#pragma unroll
    for (int j = 0; j < kSliceD / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V on this warp's D slice: the S accumulators of two n-tiles
    // form one A fragment; V's B fragments come row-major via ldmatrix.trans,
    // two n-tiles per load (lanes 0-7 / 8-15: keys 0-7 / 8-15 of n-tile j,
    // lanes 16-31: the same keys of n-tile j + 1).
    const uint32_t sV = sV0 + slot + v_frag;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kSliceD / 8; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + kk * 16 * Sm::kRowBytes + 16 * j);
        mma_16816(acc[j], pa, vf[0], vf[1]);
        mma_16816(acc[j + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // Full row sums across the 4 threads of a row group, then normalize.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = row_sum[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[r] = 1.f / t;
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
  const int row0 = m0 + rg * 16 + g;
#pragma unroll
  for (int j = 0; j < kSliceD / 8; ++j) {
    const int col = dq * kSliceD + j * 8 + t4 * 2;
    if (row0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * o_ss + col) =
          __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    }
    if (row0 + 8 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(row0 + 8) * o_ss + col) =
          __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

template <int D, int kGroups>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   const long long* st, float scale, cudaStream_t stream) {
  using Sh = WideShape<D, kGroups>;
  const size_t smem = WideSmem<D, kGroups>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wide_attn_fwd_kernel<D, kGroups>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + Sh::kBlockM - 1) / Sh::kBlockM, H, B);
  const float log2e = 1.4426950408889634f;
  wide_attn_fwd_kernel<D, kGroups><<<grid, Sh::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale * log2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, S, H, D) bf16 with unit stride along D; strides in elements
// as (batch, seq, head) for q, k, v, o in that order.  Returns a cudaError_t.
extern "C" int lp_wide_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int D, long long q_sb,
                                     long long q_ss, long long q_sh, long long k_sb,
                                     long long k_ss, long long k_sh, long long v_sb,
                                     long long v_ss, long long v_sh, long long o_sb,
                                     long long o_ss, long long o_sh, float scale,
                                     void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 384) return (int)launch<384, 4>(q, k, v, o, B, S, H, st, scale, s);
  if (D == 512) return (int)launch<512, 4>(q, k, v, o, B, S, H, st, scale, s);
  if (D == 640) return (int)launch<640, 2>(q, k, v, o, B, S, H, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
