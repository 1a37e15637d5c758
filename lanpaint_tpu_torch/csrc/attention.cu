// Flash-attention forward for NVIDIA Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernels of lanpaint_tpu/models/layers.py:
// `attention_bshd`'s flash branch (jax.experimental.pallas.ops.tpu
// .flash_attention, layers.py:238) and `_splash_attention` /
// `_splash_kernel` (splash_attention_kernel.make_splash_mha, layers.py:103-173).
// Both compute non-causal softmax(Q K^T * scale) V with fp32 accumulation.
//
// What bounds it on this card: compute.  At the SDXL-1024 shapes (S = 4096 /
// 1024, D = 64) the kernel does 4*S*D flops per query row and reads each K/V
// tile once per 64-query block, far above the H100's ~295 flop/byte ridge,
// so the tensor cores and the softmax arithmetic between them are the
// limit.  This first design reaches ~9% of the bf16 tensor-core peak (464 us
// a call at S=4096, H=10 on an NVIDIA H100 80GB HBM3 at 700 W): its K/V tile
// loads are synchronous, with no copy/compute overlap.
//
// Design (simple and correct first; no TMA / wgmma yet):
//   * one block of 4 warps per (batch, head, 64-query tile); each warp owns
//     16 query rows, held in registers as mma.sync m16n8k16 bf16 A fragments;
//   * a loop over 64-key tiles: the block stages K (row-major) and V
//     (transposed, so both B operands are read as contiguous bf16 pairs) in
//     shared memory with 16-byte loads; S = Q K^T and O += P V run on the
//     tensor cores with fp32 accumulators; the online softmax (running row
//     max and sum, exp2 with the scale folded into log2 units) stays in
//     registers, so no S x S matrix ever reaches device memory;
//   * q/k/v are read in the JAX layout (B, S, H, D) through element strides
//     (the fused-QKV projection's split views need no copy); rows past S are
//     zero-filled on load and keys past S are masked to -inf, which replaces
//     the TPU path's segment-id padding for ragged S (e.g. 1000, 5400).
//
// Interface: a plain C function (ctypes), launching on the caller's stream
// and returning cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBlockN = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of padding per shared-memory row
constexpr int kVec = 8;       // bf16 elements per 16-byte vector load

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <int D>
struct Smem {
  static constexpr int kLdQK = D + kPad;        // row stride of the Q and K tiles
  static constexpr int kLdVt = kBlockN + kPad;  // row stride of the V^T tile
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (size_t(kBlockM) * kLdQK + size_t(kBlockN) * kLdQK +
                               size_t(D) * kLdVt);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                 long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                 long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLdQK = Smem<D>::kLdQK;
  constexpr int kLdVt = Smem<D>::kLdVt;
  constexpr int kVecPerRow = D / kVec;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kLdQK;
  __nv_bfloat16* sVt = sK + kBlockN * kLdQK;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  // Q tile -> shared memory (rows past S are zero).
  for (int idx = tid; idx < kBlockM * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < S) val = *reinterpret_cast<const uint4*>(qb + (long long)(m0 + r) * q_ss + c);
    *reinterpret_cast<uint4*>(sQ + r * kLdQK + c) = val;
  }
  __syncthreads();

  // This warp's 16 query rows as A fragments, one per 16-wide slice of D.
  const int wr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = sQ + (wr + g) * kLdQK + kk * 16 + t4 * 2;
    qf[kk][0] = ld_u32(p);
    qf[kk][1] = ld_u32(p + 8 * kLdQK);
    qf[kk][2] = ld_u32(p + 8);
    qf[kk][3] = ld_u32(p + 8 * kLdQK + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max (log2 units) and partial sum for rows g and g + 8
  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < S; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous K / V tile
    for (int idx = tid; idx < kBlockN * kVecPerRow; idx += kThreads) {
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * kVec;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(n0 + r) * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(n0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kLdQK + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sVt[(c + j) * kLdVt + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* p = sK + (nt * 8 + g) * kLdQK + kk * 16 + t4 * 2;
        mma_16816(s[nt], qf[kk], ld_u32(p), ld_u32(p + 8));
      }
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
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two n-tiles form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* p = sVt + (j * 8 + g) * kLdVt + kk * 16 + t4 * 2;
        mma_16816(acc[j], pa, ld_u32(p), ld_u32(p + 8));
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
  const int row0 = m0 + wr + g;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  const float log2e = 1.4426950408889634f;
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale * log2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, S, H, D) bf16 with unit stride along D; strides in elements
// as (batch, seq, head) for q, k, v, o in that order.  Returns a cudaError_t.
extern "C" int lp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
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
  if (D == 64) return (int)launch<64>(q, k, v, o, B, S, H, st, scale, s);
  if (D == 128) return (int)launch<128>(q, k, v, o, B, S, H, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
