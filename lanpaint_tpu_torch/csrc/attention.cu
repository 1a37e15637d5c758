// Flash-attention forward for NVIDIA Hopper (sm_90a), bf16 in / bf16 out, D = 64 or 128.
//
// Replaces the Pallas TPU kernels of lanpaint_tpu/models/layers.py:
// `attention_bshd`'s flash branch (jax.experimental.pallas.ops.tpu
// .flash_attention, layers.py:238) and `_splash_attention` /
// `_splash_kernel` (splash_attention_kernel.make_splash_mha, layers.py:103-173).
// Both compute non-causal softmax(Q K^T * scale) V with fp32 accumulation.
// It also takes cross-attention, Sk keys other than the Sq queries: Wan's
// attention to its 512 text tokens, which the JAX package leaves to XLA
// (`attention_bshd(impl="auto")`, layers.py:176, jax.nn.dot_product_attention
// with bf16 operands, fp32 logits and softmax, P cast to bf16 for P V: the
// arithmetic of this kernel).
//
// What bounds it on this card: the tensor cores.  A self-attention call
// does 4*B*H*S^2*D flops on 8*B*S*H*D bytes of q/k/v/out, ~S flops a byte
// (1,000-8,000 at the main paths' S) against the H100's ~295 flop/byte
// ridge.  A cross call does 4*B*H*Sq*Sk*D flops on 4*B*H*(Sq + Sk)*D bytes,
// Sq*Sk / (Sq + Sk) flops a byte: 482 at Wan's Sq = 7,920, Sk = 512, still
// on the tensor cores' side of the ridge (100.8 us at (2, 7,920, 24, 128),
// its bytes 61.9 us); a short key run (Sk = 77) is bound by its bytes.  A
// block of a short key run does little work against a fixed cost that
// nothing overlaps: at Sk = 512 four key tiles, 33.5 MFLOP or ~4.5 us of
// one SM's tensor-core rate, against ~1.5-2.5 us of barrier set-up, the Q
// load and the first K tile before any wgmma, and the normalise-and-store
// of 32 KB.  With one block a query tile (2,976 at Wan's batch-2 shape,
// ~22.5 waves on 132 SMs) the call took 264.0 us, 38.2% of its bound.  So
// a key run of at most kShortTiles tiles takes a persistent instantiation:
// one block an SM walks the (query tile, head, batch) items, its producer
// loading the next item's Q into a second Q buffer (192 KB of shared memory
// at D = 128: 2 x 32 KB of Q, 2 x 64 KB of K/V stages) and its first K/V
// tiles into the ring while the consumers finish and store the item before:
// 229.7 us, 43.9% (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700 W;
// flash SDPA 182.6 us).  What remains per item is the consumers' own
// normalise-and-store, which nothing overlaps yet.  The first design
// (mma.sync m16n8k16 fed by 32-bit shared-memory loads, K/V staged through
// registers with two __syncthreads a tile, V transposed element by element)
// reached 8-9% of the bf16 tensor-core peak: it was bound by shared-memory
// instructions and by loads that the tensor cores waited for.
//
// This design reaches 56-59% of the bf16 peak at D = 128 (Flux's S = 4,608
// and Wan's S = 7,920) and 19-34% at D = 64 (SDXL's S = 1,024 and 4,096,
// where 160 and 320 blocks fill 132 SMs in few waves), within 1.2x of
// PyTorch's flash SDPA at each (chip_smoke.py phase 3, NVIDIA H100 80GB
// HBM3 at 700 W).  It gives the tensor cores what Hopper needs:
//   * wgmma for both products: S = Q K^T as m64n128k16 with Q and K read
//     from shared memory (both K-major), O += P V as m64n{D}k16 with P in
//     registers (the S accumulator converted to bf16 A fragments in place)
//     and V read from shared memory as it lies (MN-major B, the transpose
//     bit): no operand passes through a thread's load instructions;
//   * TMA: one 4D tensor map per operand over (D, H, S, B), built from the
//     tensor's own strides (the fused-QKV split views and Flux's column
//     slice need no copy), 64-column boxes with the 128-byte swizzle that
//     wgmma's descriptors read (a D = 128 row is two boxes); rows past Sq
//     or Sk arrive as zeros from TMA's out-of-bounds fill and keys past Sk
//     are masked to -inf in the last tile (a zero key would score 0, not
//     -inf);
//   * warp specialisation: one producer warpgroup (one thread of it issues
//     every TMA copy) and two consumer warpgroups of 64 query rows each, so
//     a block covers 128 queries and reads each K/V tile once for them;
//     K/V tiles of 128 keys flow through a ring of shared-memory stages,
//     each completing on an mbarrier (separate K and V barriers, so Q K^T
//     starts before V lands) and released by the consumers' 8 warps on an
//     "empty" mbarrier; `setmaxnreg` moves registers from the producer (24)
//     to the consumers (240): 64 fp32 S and 64 O accumulators a thread at
//     D = 128;
//   * the online softmax stays in registers (running max and sum, exp2 with
//     the scale folded into log2 units, 4-lane shuffles): the wgmma
//     accumulator gives a warp the same row/column ownership as mma.sync's
//     m16n8 fragments, so the S x S matrix never reaches memory.
// Tiles: 128 queries (two consumers) and 128 keys a block at both D, a
// ring of 2 K/V stages: shared memory holds Q and the ring, 160 KB at D =
// 128 (32 + 2 x 64) and 80 KB at D = 64.  The depth was chosen on the card
// (scripts/measure_torch_attention_stages.py, NVIDIA H100 80GB HBM3 at
// 700 W, device us in two turns): at D = 128 two stages took 463.0 / 465.6
// us at Flux's (1, 4608, 24, 128) and 1,314.3 / 1,337.3 at Wan's (1, 7920,
// 24, 128), three 474.1 / 474.5 and 1,342.3 / 1,341.0; at D = 64, S =
// 4,096, two, three, four and six stages took 128.5, 136.4, 128.3 and
// 135.5 us.  With the producer a tile ahead the loads are not what bounds
// the kernel, so a deeper ring buys nothing.  Not done here (later
// levers): ping-pong scheduling of the two consumers, the softmax of one
// tile overlapped with the next tile's Q K^T, the persistent scheduler for
// long key runs, the output stored through shared memory by TMA.
//
// A wait on an mbarrier that has not completed within ~2^34 cycles (~9 s)
// traps, so a fault in the pipeline fails the launch instead of hanging it.
// The mbarrier, TMA and wgmma helpers live in hopper.cuh, shared with the
// wide-head kernel (wide_attention.cu).
//
// Interface: a plain C function (ctypes).  The tensor maps' geometry (dims,
// byte strides, boxes) comes from the caller (ops/attention.py computes and
// checks it in Python); cuTensorMapEncodeTiled, a driver-API function, is
// reached through cudaGetDriverEntryPoint, so the library links no libcuda.
// It launches on the caller's stream and returns a cudaError_t.

#include <math_constants.h>

#include <climits>

#include "hopper.cuh"

namespace {

using namespace lp;

// K/V ring depth by head dim; a build may set them (-D) to compare depths
// (scripts/measure_torch_attention_stages.py)
#ifndef LP_ATTN_STAGES_D64
#define LP_ATTN_STAGES_D64 2
#endif
#ifndef LP_ATTN_STAGES_D128
#define LP_ATTN_STAGES_D128 2
#endif

constexpr int kBlockN = 128;    // keys per K/V tile
// A key run of at most this many tiles takes the persistent instantiation:
// Wan's cross-attention (Sk = 512, four tiles) and CLIP-length runs (77,
// one).  Every self-attention launch of the main paths has S >= 1,024, eight
// tiles or more, and keeps the grid of one block a query tile.
constexpr int kShortTiles = 4;

template <int D, bool kPersistent>
struct Tile {
  static constexpr int kConsumers = 2;                  // consumer warpgroups
  static constexpr int kBlockM = 64 * kConsumers;       // queries a block
  static constexpr int kStages = D == 128 ? LP_ATTN_STAGES_D128 : LP_ATTN_STAGES_D64;
  static constexpr int kChunks = D / kBoxCols;          // boxes across a row
  static constexpr int kThreads = kWarpgroup * (kConsumers + 1);
  // Q buffers: the persistent block loads its next item's Q into the second
  // while the consumers work on the first
  static constexpr int kQBufs = kPersistent ? 2 : 1;
  static constexpr uint32_t kQBytes = kBlockM * D * 2;
  static constexpr uint32_t kKVBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr size_t kSmem = 1024 /* alignment */ + kQBufs * size_t(kQBytes) +
                                  2 * size_t(kStages) * kKVBytes + 256 /* barriers */;
  static_assert(kSmem <= 232448, "shared memory per block");
};

// ---- the kernel ------------------------------------------------------------

// One block a (query tile, head, batch) item, the grid's own coordinates;
// or, with kPersistent, a block an SM walking items blockIdx.x, + gridDim.x,
// ... (query tile fastest, so that neighbouring blocks read one head's K/V
// from L2), of `items` = ceil(Sq / 128) * H * B.  The producer's ring of K/V
// stages runs on across items, and it loads an item's Q and first K/V tiles
// while the consumers still finish and store the item before.
template <int D, bool kPersistent>
__global__ void __launch_bounds__(Tile<D, kPersistent>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int Sq,
                 int Sk, int H, int items, long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2) {
  using T = Tile<D, kPersistent>;
  constexpr int kStages = T::kStages;
  constexpr int kChunks = T::kChunks;
  constexpr uint32_t kChunkQ = T::kBlockM * kRowBytes;  // bytes of one Q box
  constexpr uint32_t kChunkKV = kBlockN * kRowBytes;    // bytes of one K or V box

  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that grain
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + T::kQBufs * T::kQBytes;
  unsigned char* sV = sK + kStages * T::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * T::kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + T::kQBufs;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  uint64_t* q_empty = empty + kStages;  // kPersistent: a Q buffer free again

  const int m_tiles = (Sq + T::kBlockM - 1) / T::kBlockM;
  const int n_tiles = (Sk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / kWarpgroup;
  // item `it` of this block: false past the last; sets its first query
  // row, head and batch
  auto item = [&](int it, int& m0, int& h, int& b) {
    if constexpr (kPersistent) {
      const int i = blockIdx.x + it * gridDim.x;
      if (i >= items) return false;
      m0 = (i % m_tiles) * T::kBlockM;
      h = (i / m_tiles) % H;
      b = i / (m_tiles * H);
      return true;
    } else {
      m0 = blockIdx.x * T::kBlockM;
      h = blockIdx.y;
      b = blockIdx.z;
      return it == 0;
    }
  };

  if (threadIdx.x == 0) {
    for (int q = 0; q < T::kQBufs; ++q) {
      mbar_init(&q_full[q], 1);
      if constexpr (kPersistent) mbar_init(&q_empty[q], 4 * T::kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * T::kConsumers);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == T::kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x % kWarpgroup == 0) {
      int kv = 0;  // K/V tiles issued over the block's items: the ring's position
      int m0, h, b;
      for (int it = 0; item(it, m0, h, b); ++it) {
        const int qb = it % T::kQBufs;
        unsigned char* q_buf = sQ + qb * T::kQBytes;
        // the first use of each buffer passes at once
        if constexpr (kPersistent) mbar_wait(&q_empty[qb], ((it / T::kQBufs) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], T::kQBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(q_buf + c * kChunkQ, &tq, &q_full[qb], c * kBoxCols, h, m0, b);
        for (int j = 0; j < n_tiles; ++j, ++kv) {
          const int s = kv % kStages;
          mbar_wait(&empty[s], ((kv / kStages) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(&k_full[s], T::kKVBytes);
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            tma_load_4d(sK + s * T::kKVBytes + c * kChunkKV, &tk, &k_full[s], c * kBoxCols, h,
                        j * kBlockN, b);
          mbar_expect_tx(&v_full[s], T::kKVBytes);
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            tma_load_4d(sV + s * T::kKVBytes + c * kChunkKV, &tv, &v_full[s], c * kBoxCols, h,
                        j * kBlockN, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: query rows m0 + 64 wg .. + 63 of each item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % kWarpgroup;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int t4 = lane & 3;  // thread within the group

    int kv = 0;  // K/V tiles consumed over the block's items
    int m0, h, b;
    for (int it = 0; item(it, m0, h, b); ++it) {
      const int qb = it % T::kQBufs;
      float acc[D / 2];  // O: 64 rows x D, rows g and g + 8 of this warp's 16
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};  // log2 units
      float row_sum[2] = {0.f, 0.f};  // this thread's partial sums

      mbar_wait(&q_full[qb], (it / T::kQBufs) & 1);
      const unsigned char* q_rows = sQ + qb * T::kQBytes + wg * 64 * kRowBytes;

      for (int j = 0; j < n_tiles; ++j, ++kv) {
        const int s = kv % kStages;
        const uint32_t parity = (kv / kStages) & 1;
        const unsigned char* k_tile = sK + s * T::kKVBytes;
        const unsigned char* v_tile = sV + s * T::kKVBytes;

        // S = Q K^T: 64 x 128 fp32, D / 16 k-steps; a k-step of 16 columns is
        // 32 bytes into a 128-byte swizzled row, a D = 128 row two boxes.
        float sc[64];
        mbar_wait(&k_full[s], parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4;
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n128(sc, make_desc(q_rows + c * kChunkQ + off, 16, 8 * kRowBytes),
                        make_desc(k_tile + c * kChunkKV + off, 16, 8 * kRowBytes), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // Keys past Sk (last tile only) to -inf, then the online softmax in
        // log2 units.  Register i holds row g + 8 ((i >> 1) & 1), key
        // 8 (i >> 2) + 2 t4 + (i & 1) of the tile.
        if ((j + 1) * kBlockN > Sk) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int key = j * kBlockN + 8 * (i >> 2) + 2 * t4 + (i & 1);
            if (key >= Sk) sc[i] = -CUDART_INF_F;
          }
        }
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // every tile holds at least one key < Sk, so the new max is finite
          const float m_new = fmaxf(row_max[r], mx[r] * scale_log2);
          alpha[r] = exp2f(row_max[r] - m_new);
          row_max[r] = m_new;
          row_sum[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2f(fmaf(sc[i], scale_log2, -row_max[r]));
          row_sum[r] += sc[i];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // O += P V: the S accumulators of two 8-key n-tiles form one bf16 A
        // fragment; V is the MN-major B operand (LBO: the next 64 columns of
        // D, SBO: the next 8 keys), 16 keys = 2,048 bytes a k-step.
        uint32_t pa[kBlockN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        mbar_wait(&v_full[s], parity);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          wgmma_rs(acc, pa[kk], make_desc(v_tile + kk * 16 * kRowBytes, kChunkKV, 8 * kRowBytes));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
      }
      // this warp's last Q K^T has completed: the producer may load the Q
      // of the item after next into this buffer
      if constexpr (kPersistent)
        if (lane == 0) mbar_arrive(&q_empty[qb]);

      // Full row sums across the 4 threads of a row group, then normalise
      // and store the rows < Sq.
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t = row_sum[r];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        inv[r] = 1.f / t;
      }
      const int row0 = m0 + wg * 64 + warp * 16 + g;
      __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + t4 * 2;
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * o_ss + col) =
              __floats2bfloat162_rn(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
        if (row0 + 8 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(row0 + 8) * o_ss + col) =
              __floats2bfloat162_rn(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int D, bool kPersistent>
cudaError_t launch_kernel(const CUtensorMap (&maps)[3], void* o, int B, int Sq, int Sk, int H,
                          long long o_sb, long long o_ss, long long o_sh, float scale,
                          cudaStream_t stream) {
  using T = Tile<D, kPersistent>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, kPersistent>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int m_tiles = (Sq + T::kBlockM - 1) / T::kBlockM;
  const long long items = (long long)m_tiles * H * B;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  dim3 grid(m_tiles, H, B);
  if constexpr (kPersistent) {  // one block an SM, or one an item where there are fewer
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    grid = dim3((unsigned)(items < sms ? items : sms));
  }
  const float log2e = 1.4426950408889634f;
  flash_fwd_kernel<D, kPersistent><<<grid, T::kThreads, T::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), Sq, Sk, H, (int)items, o_sb,
      o_ss, o_sh, scale * log2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, const long long* geom, long long o_sb, long long o_ss, long long o_sh,
                   float scale, cudaStream_t stream) {
  // the geometry must be the one this kernel reads: the problem's dims (Sq
  // rows of q, Sk of k and v) and 64-column boxes of kBlockM (Q) or kBlockN
  // (K, V) rows, the same in both instantiations
  CUtensorMap maps[3];
  if (!geometry_matches(geom, B, Sq, Sk, H, D, Tile<D, false>::kBlockM, kBlockN) ||
      !encode_qkv(maps, q, k, v, geom))
    return cudaErrorInvalidValue;
  if ((Sk + kBlockN - 1) / kBlockN <= kShortTiles)
    return launch_kernel<D, true>(maps, o, B, Sq, Sk, H, o_sb, o_ss, o_sh, scale, stream);
  return launch_kernel<D, false>(maps, o, B, Sq, Sk, H, o_sb, o_ss, o_sh, scale, stream);
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, H, D) bf16 tensors described by `geom`
// (3 x 11 int64s: for q, k, v in turn dims (D, H, S, B), byte strides of H,
// S and B, and the box (64, 1, rows, 1)); o: (B, Sq, H, D) bf16 with unit
// stride along D and element strides (batch, seq, head).  Self-attention
// passes Sk = Sq.  Returns a cudaError_t.
extern "C" int lp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int H, int D,
                                      const long long* geom, long long o_sb, long long o_ss,
                                      long long o_sh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)launch<64>(q, k, v, o, B, Sq, Sk, H, geom, o_sb, o_ss, o_sh, scale, s);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, B, Sq, Sk, H, geom, o_sb, o_ss, o_sh, scale, s);
  return (int)cudaErrorInvalidValue;
}
