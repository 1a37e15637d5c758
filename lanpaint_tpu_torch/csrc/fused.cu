// The think step's two pointwise phases for NVIDIA Hopper (sm_90a): the
// half step before the model and the finish after it, warm or cold.
//
// Replaces the Pallas TPU kernels of lanpaint_tpu/ops/fused.py:
// `fused_half_step` (`_half_kernel`, pallas_call at :239) and `fused_finish`
// (`_finish_kernel`, pallas_call at :259).  Same contract: the same inputs
// and outputs, the same (B, 24) coefficient tables (ops/fused.py
// `pack_branch_coeffs`), the mask-mixed damped SHO step and overdamped OU
// step, and the same non-finite selects, the warm finish's on its own damped
// result only.  Only the random stream differs from the TPU's (below).
//
// What bounds it on this card: bytes, and at latent sizes the launch.  An
// element costs 20-32 bytes of fp32 traffic and ~60 flops of mixing, plus
// its normals: 262,144 elements (Flux-dev 1024) are 5.2-8.4 MB, ~1.6-2.5 us
// at 3.35 TB/s, about what a launch costs.  So the kernel keeps the device's
// work near the bytes and the host's near one call:
//   * flat and vectorised: the (B, M) view is cut into quads, four elements
//     of consecutive flat index e (quad q = e >> 2); a thread takes QUADS
//     quads blockDim.x apart (consecutive threads, consecutive quads), each
//     moved with 16-byte loads and stores where it lies wholly in its batch
//     row and every pointer is 16-byte aligned, else element by element (the
//     scalar path: a quad that straddles two rows when M % 4 != 0, or an
//     unaligned view).  Grid (ceil(quads a row / (threads * QUADS)), B);
//     block (bx, b) takes row b's quads [b*M >> 2, (b*M + M + 3) >> 2) from
//     the (bx * QUADS + k) * threads + t-th on, and of each only row b's
//     elements (emulated on the CPU by tests/test_torch_fused_philox.py);
//   * block-uniform coefficients: the block reads its row's two 24-float
//     table rows once into shared memory; each thread keeps the x-branch
//     value and the y - x difference of each slot it uses in registers and
//     mixes them per element by the mask;
//   * normals in registers, no noise tensor in device memory: a hand-written
//     Philox4x32-10 (Random123's constants) and Box-Muller.  Stream j (0, 1,
//     2 = ey, ev, vs in the half step; ey2, ev2, vs in the finish) of element
//     e is lane g % 4 of Philox(counter (g >> 2, launch, j, 0), key (seed_lo,
//     seed_hi)) with g = offset + e, the element's index in the whole batch
//     (a data-parallel rank's view starts at its first row's, offset =
//     rows.start * M; 0 in one process): one call gives four words, two
//     Box-Muller pairs, a quad's four normals.  u1 = (w0 >> 8) * 2^-24 +
//     2^-25 (never 0), u2 = (w1 >> 8) * 2^-24, r = sqrt(-2 ln u1), normals
//     (r cos 2 pi u2, r sin 2 pi u2) as the TPU kernel maps its bits
//     (lanpaint_tpu/ops/fused.py:95-99), with the accurate logf, sqrtf and
//     sincospif.  Where the offset is not a multiple of 4 the view's quads no
//     longer line up with the global ones: each thread then computes its
//     quad's two global quads (g >> 2 and the next), draws both and takes
//     its four lanes from the eight (two Philox calls a stream instead of
//     one; the loads and stores keep their 16-byte path, which follows the
//     view's own quads).  The counter is a function of the global index
//     alone, so the draw depends neither on the block shape nor on how the
//     batch is split over ranks, and the launch index in it keeps launches'
//     streams disjoint.
//     vs is drawn only where it is read: always in the cold finish (its
//     stationary velocity); in the half step and the warm finish only for a
//     quad with a non-finite damped result.  The CPU twin
//     (ops/fused.py `philox_normals`, with the same offset) draws the same
//     numbers;
//   * one launch through a plain C function (ctypes).
//
// Interface: lp_fused_think (below); it launches on the caller's stream and
// returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kCoef = 12;          // slots of a table row
constexpr int kTable = 2 * kCoef;  // a batch row of a table: the half row, then the full row
constexpr int kMaxThreads = 256;
enum Phase { kHalf = 0, kWarm = 1, kCold = 2 };

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R with R = 10)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// two standard normals from two words: w0 gives the radius, w1 the angle
__device__ __forceinline__ void box_muller(unsigned w0, unsigned w1, float& n0, float& n1) {
  const float u1 = __uint2float_rn(w0 >> 8) * 0x1p-24f + 0x1p-25f;
  const float u2 = __uint2float_rn(w1 >> 8) * 0x1p-24f;
  const float r = sqrtf(-2.f * logf(u1));
  float s, c;
  sincospif(2.f * u2, &s, &c);
  n0 = r * c;
  n1 = r * s;
}

// the four normals of global quad q, lane l for element 4q + l
__device__ __forceinline__ void quad_normals(unsigned q, unsigned launch, unsigned j, uint2 key,
                                             float& n0, float& n1, float& n2, float& n3) {
  const uint4 w = philox4x32_10(make_uint4(q, launch, j, 0u), key);
  box_muller(w.x, w.y, n0, n1);
  box_muller(w.z, w.w, n2, n3);
}

// stream j's normals of global elements g .. g + 3: lane g % 4 of quad g >> 2
// on; where g % 4 != 0 (uniform over the launch: the offset's) they span two
// quads, drawn both, the lanes picked with constant indices (registers only)
__device__ __forceinline__ void normals4(unsigned g, unsigned launch, unsigned j, uint2 key,
                                         float (&n)[4]) {
  float w[8];
  quad_normals(g >> 2, launch, j, key, w[0], w[1], w[2], w[3]);
  const unsigned shift = g & 3u;
  if (shift == 0) {
#pragma unroll
    for (int l = 0; l < 4; ++l) n[l] = w[l];
    return;
  }
  quad_normals((g >> 2) + 1, launch, j, key, w[4], w[5], w[6], w[7]);
#pragma unroll
  for (int l = 0; l < 4; ++l) n[l] = shift == 1 ? w[l + 1] : shift == 2 ? w[l + 2] : w[l + 3];
}

// The quad at flat index e: lanes inside [lo, hi) (this block's row), 16
// bytes at once where `full`; the other lanes read as 0 and are not stored.
__device__ __forceinline__ void load4(const float* __restrict__ p, unsigned e, unsigned lo,
                                      unsigned hi, bool full, float (&out)[4]) {
  if (full) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + e));
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) out[l] = (e + l >= lo && e + l < hi) ? __ldg(p + e + l) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ p, unsigned e, unsigned lo,
                                       unsigned hi, bool full, const float (&in)[4]) {
  if (full) {
    *reinterpret_cast<float4*>(p + e) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (e + l >= lo && e + l < hi) p[e + l] = in[l];
  }
}

// PHASE: kHalf reads x (the state), v, c_old, mask and writes out_x, out_v,
// out_x_od (x_half, v_half, x_half_overdamped); kWarm reads x = x_half,
// v = v_half, x_od = x_half_overdamped, c_old, c_new, mask; kCold reads
// x = x_in, c_new, mask; both finishes write out_x, out_v.
template <int PHASE, int QUADS>
__global__ void __launch_bounds__(kMaxThreads)
fused_think_kernel(const unsigned long long* __restrict__ seed, unsigned launch,
                   unsigned offset, const float* __restrict__ coef_x,
                   const float* __restrict__ coef_y, const float* __restrict__ x,
                   const float* __restrict__ v,
                   const float* __restrict__ x_od, const float* __restrict__ c_old,
                   const float* __restrict__ c_new, const float* __restrict__ mask,
                   float* __restrict__ out_x, float* __restrict__ out_v,
                   float* __restrict__ out_x_od, unsigned m, float nm, bool vec) {
  // The table first, behind the block's one barrier; then the seed and the
  // quads' inputs are loaded and the normals (which need only the seed) are
  // drawn while the inputs are in flight.  Of the orders timed with
  // scripts/measure_torch_fused.py (NVIDIA H100 80GB HBM3, 700 W), this was
  // the fastest: with the barrier after the draw, the block's warps waited
  // there for its slowest one (0.4-0.9 us slower at Flux's size); with no
  // barrier, each thread loading the table rows itself, 0.02-0.1 us slower.
  __shared__ float tab[2 * kTable];  // batch row b of coef_x, then of coef_y
  const unsigned row = blockIdx.y;
  if (threadIdx.x < 2 * kTable)
    tab[threadIdx.x] = threadIdx.x < kTable ? coef_x[row * kTable + threadIdx.x]
                                            : coef_y[row * kTable + threadIdx.x - kTable];
  __syncthreads();
  // the half row's slots, or the full row's for the cold finish: the x
  // branch's value and y - x, mixed per element as cx + (cy - cx) * mask
  constexpr int R = PHASE == kCold ? kCoef : 0;
  float cx[kCoef - 1], cd[kCoef - 1];
#pragma unroll
  for (int j = 0; j < kCoef - 1; ++j) {
    cx[j] = tab[R + j];
    cd[j] = tab[kTable + R + j] - cx[j];
  }
  // the warm kicks: sqrt(Gamma) dt (half row, slot 11) and dt (full row)
  const float kv_x = tab[kCoef - 1], kv_d = tab[kTable + kCoef - 1] - kv_x;
  const float kx_x = tab[kTable - 1], kx_d = tab[2 * kTable - 1] - kx_x;

  const unsigned long long s = *seed;
  const unsigned lo = row * m, hi = lo + m;  // this row's flat elements
  const unsigned q_first = lo >> 2, q_end = (hi + 3) >> 2;
  unsigned e[QUADS], elo[QUADS], ehi[QUADS];
  bool full[QUADS];
  float xs[QUADS][4], v_in[QUADS][4], xo_in[QUADS][4], co[QUADS][4], cn[QUADS][4],
      mk[QUADS][4];
#pragma unroll
  for (int k = 0; k < QUADS; ++k) {
    const unsigned q = q_first + (blockIdx.x * QUADS + k) * blockDim.x + threadIdx.x;
    const bool live = q < q_end;
    e[k] = 4 * q;
    elo[k] = live ? lo : 0;  // a quad past the row has no lanes
    ehi[k] = live ? hi : 0;
    full[k] = vec && live && e[k] >= lo && e[k] + 4 <= hi;
    load4(x, e[k], elo[k], ehi[k], full[k], xs[k]);
    load4(mask, e[k], elo[k], ehi[k], full[k], mk[k]);
    if (PHASE != kCold) {
      load4(v, e[k], elo[k], ehi[k], full[k], v_in[k]);
      load4(c_old, e[k], elo[k], ehi[k], full[k], co[k]);
    }
    if (PHASE != kHalf) load4(c_new, e[k], elo[k], ehi[k], full[k], cn[k]);
    if (PHASE == kWarm) load4(x_od, e[k], elo[k], ehi[k], full[k], xo_in[k]);
  }

  const uint2 key = make_uint2((unsigned)s, (unsigned)(s >> 32));
  float ey[QUADS][4], ev[QUADS][4], vs[QUADS][4] = {};
#pragma unroll
  for (int k = 0; k < QUADS; ++k) {
    normals4(offset + e[k], launch, 0u, key, ey[k]);
    normals4(offset + e[k], launch, 1u, key, ev[k]);
    if (PHASE == kCold) normals4(offset + e[k], launch, 2u, key, vs[k]);
  }

#pragma unroll
  for (int k = 0; k < QUADS; ++k) {
    float yd[4], vd[4], xo[4];
    bool all_ok = true;
    bool ok[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float w = mk[k][l];
      float c_[kCoef - 1];
#pragma unroll
      for (int j = 0; j < kCoef - 1; ++j) c_[j] = cx[j] + cd[j] * w;
      const float l_yy = c_[4] * nm, l_vy = c_[5] * nm, l_vv = c_[6] * nm, ns = c_[9] * nm;
      const float a = c_[10];
      const float y0 = xs[k][l];
      float v0, c, x0_ou;
      if (PHASE == kHalf) {
        v0 = v_in[k][l], c = co[k][l], x0_ou = y0;
      } else if (PHASE == kWarm) {
        const float dc = cn[k][l] - co[k][l];
        v0 = v_in[k][l] + (kv_x + kv_d * w) * dc;
        x0_ou = xo_in[k][l] + (kx_x + kx_d * w) * dc;
        c = co[k][l];
      } else {
        v0 = vs[k][l] * nm, c = cn[k][l], x0_ou = y0;
      }
      const float drive = c - a * y0;
      yd[l] = y0 + c_[0] * drive + c_[1] * v0 + l_yy * ey[k][l];
      vd[l] = c_[2] * drive + c_[3] * v0 + l_vy * ey[k][l] + l_vv * ev[k][l];
      xo[l] = c_[7] * x0_ou + c_[8] * c + ns * ey[k][l];
      ok[l] = isfinite(yd[l]) && isfinite(vd[l]);
      all_ok = all_ok && ok[l];
    }
    // vs is read only where a damped result is not finite (always when cold)
    if (PHASE != kCold && !all_ok) normals4(offset + e[k], launch, 2u, key, vs[k]);
    float ox[4], ov[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      ox[l] = ok[l] ? yd[l] : xo[l];
      ov[l] = ok[l] ? vd[l] : vs[k][l] * nm;
    }
    store4(out_x, e[k], elo[k], ehi[k], full[k], ox);
    store4(out_v, e[k], elo[k], ehi[k], full[k], ov);
    if (PHASE == kHalf) store4(out_x_od, e[k], elo[k], ehi[k], full[k], xo);
  }
}

template <int PHASE, int QUADS>
cudaError_t launch(dim3 grid, int threads, cudaStream_t stream, const void* seed,
                   unsigned launch_index, unsigned offset, const float* coef_x,
                   const float* coef_y, const float* x, const float* v, const float* x_od,
                   const float* c_old, const float* c_new, const float* mask, float* out_x,
                   float* out_v, float* out_x_od, unsigned m, float nm, bool vec) {
  fused_think_kernel<PHASE, QUADS><<<grid, threads, 0, stream>>>(
      static_cast<const unsigned long long*>(seed), launch_index, offset, coef_x, coef_y, x, v,
      x_od, c_old, c_new, mask, out_x, out_v, out_x_od, m, nm, vec);
  return cudaGetLastError();
}

}  // namespace

// One think-step phase on a contiguous (rows, cols) fp32 view: phase 0 the
// half step, 1 the warm finish, 2 the cold finish (the pointers each reads
// and writes: fused_think_kernel; the others may be null).  seed: one int64
// on the card, the Philox key; launch: the counter's second word, 0 <=
// launch < 2^32.  offset: the view's first element's index in the whole
// batch (a data-parallel rank's rows.start * cols), offset + rows * cols <
// 2^31.  coef_x, coef_y: (rows, 24) fp32.  rows <= 65,535.  `threads` a
// block (64-256, a multiple of 32) and `quads` a thread (1 or 2).  Returns a
// cudaError_t.
extern "C" int lp_fused_think(int phase, const void* seed, long long launch_index,
                              long long offset, const float* coef_x, const float* coef_y,
                              const float* x, const float* v, const float* x_od,
                              const float* c_old, const float* c_new, const float* mask,
                              float* out_x, float* out_v, float* out_x_od, long long rows,
                              long long cols, float noise_mult, int threads, int quads,
                              void* stream) {
  if (phase < kHalf || phase > kCold || rows <= 0 || rows > 65535 || cols <= 0 ||
      offset < 0 || offset + rows * cols >= (1ll << 31) || launch_index < 0 ||
      launch_index > 0xffffffffll ||
      threads < 64 || threads > kMaxThreads || threads % 32 || (quads != 1 && quads != 2))
    return (int)cudaErrorInvalidValue;
  // the arrays this phase reads and writes (as the kernel's loads and
  // stores): none may be null; the 16-byte path needs all of them aligned
  bool ok = seed != nullptr && coef_x != nullptr && coef_y != nullptr, vec = true;
  const auto take = [&](std::initializer_list<const void*> ps) {
    for (const void* p : ps) {
      ok = ok && p != nullptr;
      vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    }
  };
  take({x, mask, out_x, out_v});
  if (phase != kCold) take({v, c_old});
  if (phase != kHalf) take({c_new});
  if (phase == kWarm) take({x_od});
  if (phase == kHalf) take({out_x_od});
  if (!ok) return (int)cudaErrorInvalidValue;
  // quads a row: M / 4, or up to two more where rows start off a quad boundary
  const unsigned m = (unsigned)cols;
  const unsigned row_quads = m % 4 ? m / 4 + 2 : m / 4;
  const unsigned per_block = (unsigned)(threads * quads);
  const dim3 grid((row_quads + per_block - 1) / per_block, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned li = (unsigned)launch_index;
#define LP_FUSED(P, Q)                                                                       \
  return (int)launch<P, Q>(grid, threads, s, seed, li, (unsigned)offset, coef_x, coef_y, x, v, \
                           x_od, c_old, c_new, mask, out_x, out_v, out_x_od, m, noise_mult, vec)
  if (phase == kHalf) {
    if (quads == 1) LP_FUSED(kHalf, 1);
    LP_FUSED(kHalf, 2);
  }
  if (phase == kWarm) {
    if (quads == 1) LP_FUSED(kWarm, 1);
    LP_FUSED(kWarm, 2);
  }
  if (quads == 1) LP_FUSED(kCold, 1);
  LP_FUSED(kCold, 2);
#undef LP_FUSED
}
