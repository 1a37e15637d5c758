// Wide-head attention forward for NVIDIA Hopper (sm_90a), bf16 in / bf16 out,
// D = 384, 512 or 640.
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
// What bounds it on this card: a call does 4 * B * S^2 * D flops, far above
// the H100's ~295 flop/byte ridge against device memory, so the tensor
// cores bound it in principle.  But a block holds only 64 queries (Q alone
// is 80 KB at D = 640) and streams every key and value past them, so each
// call moves S / 64 times K and V from L2 to the SMs (~4.5 GB at (9, 3520,
// 1, 640)): the L2-to-SM rate is the nearer limit.  The first design
// (mma.sync from 32-bit shared-memory loads, every thread copying by cp.async,
// three __syncthreads a tile, 32-query blocks at D = 640) reached 10-15% of
// the bound.  This one takes from the D <= 128 kernel (attention.cu) what
// fits a wide head:
//   * TMA: one 4D tensor map per operand over (D, H, S, B) from the
//     tensor's own strides (the video VAE's column slices of `to_qkv` need
//     no copy), 64-column boxes under the 128-byte swizzle (a D = 640 row is
//     10 boxes), into a ring of K and V stages, each completing on its own
//     mbarrier (so Q K^T starts before V lands); rows past S arrive as
//     zeros and keys past S are masked to -inf;
//   * wgmma for both products, from two warpgroups that share the block's
//     64 queries and split the output's D in halves: warpgroup c owns O's
//     columns c * D/2 .. +D/2, 160 / 128 / 96 fp32 accumulators a thread (a
//     whole row block would be D of them);
//   * Q K^T is computed once: each warpgroup takes the partial scores over
//     its own D half (m64n32k16, Q and K from shared memory), the two
//     partials meet in shared memory (2 x 64 x 32 fp32), and each adds the
//     other's to its own.  fp32 addition commutes exactly, so both hold
//     bit-identical scores and run the same online softmax (exp2 with the
//     scale folded into log2 units, 4-lane shuffles) with no further
//     exchange; then O += P V over its half (P in registers, V read as it
//     lies, m64n128k16 / m64n64k16);
//   * no producer warp: ptxas allocates every thread of a block within the
//     register budget of the whole block, 168 at 384 threads (one producer
//     warpgroup and `setmaxnreg` 24 / 240 did not raise the consumers'
//     allocation), and a D = 640 warpgroup needs ~207; so the block is the
//     two warpgroups alone (256 threads, 255 registers), and warp 0 starts
//     every TMA copy, one box a lane, at the exchange's barrier, where both
//     warpgroups are past Q K^T of this tile and P V of the last, so the K
//     stage just read and the V stage read last are free: no "empty"
//     barriers, and each copy has about a tile (V) or two (K) to land.
// Tiles: 64 queries and 32 keys a block (one wgmma M; a 32-key tile keeps
// the scores at 16 registers a thread beside O's 160 at D = 640).  Shared
// memory: Q, 2 K stages (1 at D = 640), 2 V stages and the 16 KB exchange:
// 222,272 bytes at D = 640, 214,080 at 512, 164,928 at 384 (limit 232,448),
// one block an SM.  Not done here (later levers, ROADMAP B.6): a cluster
// of two blocks splitting the keys of one query tile when the grid is under
// one wave ((1, 4096, 1, 512): 64 blocks on 132 SMs), TMA multicast of K/V
// to a cluster pair (halving the L2-to-SM traffic), the softmax of one tile
// overlapped with the next tile's products.
//
// Interface: a plain C function (ctypes) with the D <= 128 kernel's
// signature: the tensor maps' geometry comes from the caller
// (ops/attention.py), the library links no libcuda (hopper.cuh), and it
// launches on the caller's stream and returns a cudaError_t.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace lp;

constexpr int kBlockM = 64;    // queries a block: one wgmma M
constexpr int kBlockN = 32;    // keys a K/V tile
constexpr int kConsumers = 2;  // warpgroups, one per half of D
constexpr int kThreads = kWarpgroup * kConsumers;
constexpr int kScores = kBlockM * kBlockN / kWarpgroup;  // score registers a thread (16)
constexpr uint32_t kBoxQ = kBlockM * kRowBytes;          // bytes of one Q box
constexpr uint32_t kBoxKV = kBlockN * kRowBytes;         // bytes of one K or V box

template <int D>
struct Wide {
  static constexpr int kHalf = D / kConsumers;        // O columns a warpgroup owns
  static constexpr int kChunks = D / kBoxCols;        // boxes across a row
  static constexpr int kN128 = kHalf / 128;           // m64n128 P V products a k-step
  static constexpr int kN64 = (kHalf % 128) / 64;     // and m64n64 ones (0 or 1)
  // ring depths (2 K stages would pass 232,448 bytes at D = 640; 3 and 3
  // at D = 384 took the same time as 2 and 2, 1,972.0 against 1,980.7 us)
  static constexpr int kKStages = D == 640 ? 1 : 2;
  static constexpr int kVStages = 2;
  static constexpr uint32_t kQBytes = kBlockM * D * 2;
  static constexpr uint32_t kKVBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr uint32_t kXBytes = kConsumers * kBlockM * kBlockN * 4;  // partial scores
  static constexpr size_t kSmem = 1024 /* alignment */ + kQBytes +
                                  size_t(kKStages + kVStages) * kKVBytes + kXBytes +
                                  64 /* barriers */;
  static_assert(kHalf % kBoxCols == 0, "a warpgroup's half of D is whole boxes");
  static_assert(kN128 * 128 + kN64 * 64 == kHalf, "P V products cover the half");
  static_assert(kSmem <= 232448, "shared memory per block");
};

// Called by every lane of warp 0: the K tile `k_tile` into K stage `ks`
// and the V tile `v_tile` into V stage `vs` (each where >= 0), one box a
// lane (K on lanes 0.., V on lanes 16..), so that a tile's copies leave in
// one instruction and do not hold up the warp's warpgroup.
template <int D>
__device__ __forceinline__ void load_tiles(unsigned char* sK, unsigned char* sV,
                                           const CUtensorMap* tk, const CUtensorMap* tv,
                                           uint64_t* k_full, uint64_t* v_full, int k_tile,
                                           int ks, int v_tile, int vs, int h, int b) {
  using W = Wide<D>;
  static_assert(W::kChunks <= 16, "a tile's boxes on 16 lanes");
  const int lane = threadIdx.x % 32;
  const bool is_k = lane < 16;
  const int tile = is_k ? k_tile : v_tile;
  const int box = lane % 16;
  if (tile < 0) return;
  uint64_t* bar = is_k ? &k_full[ks] : &v_full[vs];
  if (box == 0) mbar_expect_tx(bar, W::kKVBytes);
  if (box < W::kChunks)
    tma_load_4d((is_k ? sK + ks * W::kKVBytes : sV + vs * W::kKVBytes) + box * kBoxKV,
                is_k ? tk : tv, bar, box * kBoxCols, h, tile * kBlockN, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
wide_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                long long o_sb, long long o_ss, long long o_sh, float scale_log2) {
  using W = Wide<D>;
  constexpr int kKS = W::kKStages;
  constexpr int kVS = W::kVStages;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + W::kQBytes;
  unsigned char* sV = sK + kKS * W::kKVBytes;
  float* sX = reinterpret_cast<float*>(sV + kVS * W::kKVBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kVS * W::kKVBytes + W::kXBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kKS;

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / kWarpgroup;
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the group
  const int box0 = wg * (W::kHalf / kBoxCols);  // this half's first box
  const bool loader = threadIdx.x < 32;         // warp 0 starts every TMA copy

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKS; ++s) mbar_init(&k_full[s], 1);
    for (int s = 0; s < kVS; ++s) mbar_init(&v_full[s], 1);
    mbar_init_fence();
    mbar_expect_tx(q_full, W::kQBytes);
  }
  __syncwarp();
  if (loader) {
    if (lane < W::kChunks) tma_load_4d(sQ + lane * kBoxQ, &tq, q_full, lane * kBoxCols, h, m0, b);
    for (int t = 0; t < kKS || t < kVS; ++t)
      load_tiles<D>(sK, sV, &tk, &tv, k_full, v_full, t < kKS && t < n_tiles ? t : -1, t,
                    t < kVS && t < n_tiles ? t : -1, t, h, b);
  }
  __syncthreads();

  // O: rows g and g + 8 of this warp's 16, columns by n-tile of 8
  float acc[W::kN128][64];
  float acc64[W::kN64 > 0 ? W::kN64 : 1][32];
#pragma unroll
  for (int n = 0; n < W::kN128; ++n)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[n][i] = 0.f;
  if constexpr (W::kN64 > 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc64[0][i] = 0.f;
  }
  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};  // log2 units
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sums
  float* x_mine = sX + wg * kScores * kWarpgroup + tid;
  const float* x_other = sX + (1 - wg) * kScores * kWarpgroup + tid;

  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int ks = j % kKS;
    const int vs = j % kVS;
    const unsigned char* k_tile = sK + ks * W::kKVBytes;
    const unsigned char* v_tile = sV + vs * W::kKVBytes;

    // Partial S = Q K^T over this half of D: 64 x 32 fp32, kHalf / 16
    // k-steps; a k-step is 32 bytes into a 128-byte swizzled box row.  The
    // descriptors are offsets from two made in this tile (`opaque`): hoisted
    // out of the loop, the 2 x kHalf / 16 of them would stay in registers
    // beside O's.
    const uint64_t dq = make_desc(opaque(smem_u32(sQ) + box0 * kBoxQ), 16, 8 * kRowBytes);
    const uint64_t dk = make_desc(opaque(smem_u32(k_tile) + box0 * kBoxKV), 16, 8 * kRowBytes);
    float sc[kScores];
    mbar_wait(&k_full[ks], (j / kKS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W::kHalf / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n32(sc, dq + (((kk / 4) * kBoxQ + off) >> 4),
                   dk + (((kk / 4) * kBoxKV + off) >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // The two halves meet: thread tid of either warpgroup holds the same
    // (row, key) positions, so each writes its partials in register order
    // and reads the other's from the same slots.
    if (j > 0) __syncthreads();  // last tile's reads of the exchange are done
#pragma unroll
    for (int i = 0; i < kScores; ++i) x_mine[i * kWarpgroup] = sc[i];
    __syncthreads();
    // Both warpgroups are past Q K^T_j and P V_{j-1}: K stage ks and V
    // stage (j - 1) % kVS are free, and the next tiles go into them.
    if (loader) {
      const int t = j - 1 + kVS;
      load_tiles<D>(sK, sV, &tk, &tv, k_full, v_full, j + kKS < n_tiles ? j + kKS : -1, ks,
                    j > 0 && t < n_tiles ? t : -1, t % kVS, h, b);
    }
#pragma unroll
    for (int i = 0; i < kScores; ++i) sc[i] += x_other[i * kWarpgroup];

    // Keys past S (last tile only) to -inf, then the online softmax in
    // log2 units.  Register i holds row g + 8 ((i >> 1) & 1), key
    // 8 (i >> 2) + 2 t4 + (i & 1) of the tile.
    if ((j + 1) * kBlockN > S) {
#pragma unroll
      for (int i = 0; i < kScores; ++i) {
        const int key = j * kBlockN + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (key >= S) sc[i] = -CUDART_INF_F;
      }
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < kScores; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one key < S, so the new max is finite
      const float m_new = fmaxf(row_max[r], mx[r] * scale_log2);
      alpha[r] = exp2f(row_max[r] - m_new);
      row_max[r] = m_new;
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kScores; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -row_max[r]));
      row_sum[r] += sc[i];
    }
#pragma unroll
    for (int n = 0; n < W::kN128; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[n][i] *= alpha[(i >> 1) & 1];
    if constexpr (W::kN64 > 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc64[0][i] *= alpha[(i >> 1) & 1];
    }

    // O += P V over this half: the S accumulators of two 8-key n-tiles
    // form one bf16 A fragment; V is the MN-major B operand (LBO: the next
    // 64 columns, one box; SBO: the next 8 keys), 16 keys = 2,048 bytes a
    // k-step.
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    mbar_wait(&v_full[vs], (j / kVS) & 1);
#pragma unroll
    for (int n = 0; n < W::kN128; ++n) fence_regs(acc[n]);
    if constexpr (W::kN64 > 0) fence_regs(acc64[0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t dv = make_desc(opaque(smem_u32(v_tile) + box0 * kBoxKV), kBoxKV,
                                    8 * kRowBytes) + ((kk * 16 * kRowBytes) >> 4);
#pragma unroll
      for (int n = 0; n < W::kN128; ++n) wgmma_rs(acc[n], pa[kk], dv + ((2 * n * kBoxKV) >> 4));
      if constexpr (W::kN64 > 0)
        wgmma_rs(acc64[0], pa[kk], dv + ((2 * W::kN128 * kBoxKV) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < W::kN128; ++n) fence_regs(acc[n]);
    if constexpr (W::kN64 > 0) fence_regs(acc64[0]);
  }

  // Full row sums across the 4 threads of a row group, then normalise and
  // store the rows < S.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = row_sum[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[r] = 1.f / t;
  }
  const int row0 = m0 + warp * 16 + g;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh + wg * W::kHalf + t4 * 2;
  __nv_bfloat16* o_lo = ob + (long long)row0 * o_ss;
  __nv_bfloat16* o_hi = ob + (long long)(row0 + 8) * o_ss;
#pragma unroll
  for (int n = 0; n < W::kN128; ++n)
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      const int col = n * 128 + n8 * 8;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o_lo + col) =
            __floats2bfloat162_rn(acc[n][4 * n8] * inv[0], acc[n][4 * n8 + 1] * inv[0]);
      if (row0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(o_hi + col) =
            __floats2bfloat162_rn(acc[n][4 * n8 + 2] * inv[1], acc[n][4 * n8 + 3] * inv[1]);
    }
  if constexpr (W::kN64 > 0) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = W::kN128 * 128 + n8 * 8;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o_lo + col) =
            __floats2bfloat162_rn(acc64[0][4 * n8] * inv[0], acc64[0][4 * n8 + 1] * inv[0]);
      if (row0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(o_hi + col) =
            __floats2bfloat162_rn(acc64[0][4 * n8 + 2] * inv[1], acc64[0][4 * n8 + 3] * inv[1]);
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   const long long* geom, long long o_sb, long long o_ss, long long o_sh,
                   float scale, cudaStream_t stream) {
  using W = Wide<D>;
  // the geometry must be the one this instantiation reads: the problem's
  // dims and 64-column boxes of kBlockM (Q) or kBlockN (K, V) rows
  CUtensorMap maps[3];
  if (!geometry_matches(geom, B, S, H, D, kBlockM, kBlockN) || !encode_qkv(maps, q, k, v, geom))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wide_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  const float log2e = 1.4426950408889634f;
  wide_fwd_kernel<D><<<grid, kThreads, W::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), S, o_sb, o_ss, o_sh,
      scale * log2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, S, H, D) bf16 tensors described by `geom` (3 x 11 int64s:
// for q, k, v in turn dims (D, H, S, B), byte strides of H, S and B, and
// the box (64, 1, rows, 1): 64 rows for q, 32 for k and v); o: (B, S, H, D)
// bf16 with unit stride along D and element strides (batch, seq, head).
// Returns a cudaError_t.
extern "C" int lp_wide_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int D, const long long* geom,
                                     long long o_sb, long long o_ss, long long o_sh,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 384) return (int)launch<384>(q, k, v, o, B, S, H, geom, o_sb, o_ss, o_sh, scale, s);
  if (D == 512) return (int)launch<512>(q, k, v, o, B, S, H, geom, o_sb, o_ss, o_sh, scale, s);
  if (D == 640) return (int)launch<640>(q, k, v, o, B, S, H, geom, o_sb, o_ss, o_sh, scale, s);
  return (int)cudaErrorInvalidValue;
}
