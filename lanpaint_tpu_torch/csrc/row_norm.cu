// Row LayerNorm / RMSNorm over the last axis for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_norm_kernel` / `_pallas_norm`
// (lanpaint_tpu/ops/norms.py:45-141, pallas_call at :93), reached through
// `fused_layernorm` / `fused_rmsnorm`.  Same numerical contract: fp32
// statistics by flax's one-pass E[x^2] - E[x]^2, rsqrt(var + eps), an
// optional gamma and beta, the output in bf16 or fp32 (fp32 for the DiTs'
// adaLN `layernorm_na`); C <= 8192.
//
// What bounds it on this card: bytes.  A row is read once and written once
// for ~8 flops an element, far below the H100's flop/byte ridge, so the
// kernel's work is to keep enough bytes in flight and to move no others:
//   * strided rows without a copy: the caller collapses the input's leading
//     dims into at most two row dims (ops/norms.py `row_geometry`), and the
//     kernel reads row r at (r / n_inner) * s_outer + (r % n_inner) *
//     s_inner.  QKNorm's q and k are (B, S, H, D) column slices of one fused
//     projection, rows (B*S, H) with strides (3*H*D or linear1's width, D):
//     they used to be copied into a contiguous tensor before the kernel
//     read them again.  The output is contiguous;
//   * 16-byte loads (8 elements a thread at a time) and many rows a block
//     for narrow rows: `tpr` threads share a row (a power of two up to 32,
//     reduced with warp shuffles), a block holds threads / tpr rows (at
//     C = 128: 8 threads a row, 16 rows a block); wide rows take whole
//     warps (tpr a multiple of 32), their partial sums meeting in shared
//     memory in a fixed order.  Each thread keeps its
//     8 * NV elements in registers between the statistics and the output;
//   * one launch through a plain C function (ctypes): the host's work per
//     call is the wrapper's few lines of Python and this function;
//   * RoPE in the RMS mode's epilogue (the `ROPE` instantiations): the DiTs'
//     q and k go from their RMS norm straight into a rotation by the
//     `rope_freqs` table (models/layers.py `apply_rope`), which as its own
//     pass read and wrote every element five times in fp32.  Here the row
//     is already in registers: each thread's 16-byte vector is 4 adjacent
//     (even, odd) pairs of one head, so the rotation is local to the
//     thread and costs only the table's reads, (D / 2, 2, 2) fp32 a token
//     through L1, shared by the token's heads (loading a thread's matrices
//     before the statistics, and keeping them for its later vectors at the
//     same place in their heads, measured no faster).  The arithmetic is
//     apply_rope's after the norm's output rounding: the normalised value
//     rounded to the output dtype, widened, then t0 * x0 + t1 * x1 in fp32
//     with no FMA contraction and one rounding to the output dtype.  The
//     instantiations without the table are the code they were before it.
//
// Interface: lp_row_norm (below); it launches on the caller's stream and
// returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // elements a thread moves at a time (16 bytes of bf16)

// Threads a block may have with NV vectors a thread: the register cap
// (65,536 / threads) must hold the 8 * NV values without a spill.
constexpr int max_threads(int nv) { return nv <= 2 ? 1024 : 2048 / nv; }

// 16 bytes of the input, read once: not kept in L1 (where gamma and beta are)
__device__ __forceinline__ uint4 load16_stream(const void* p) {
  uint4 u;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  return u;
}

__device__ __forceinline__ void to_f32(uint4 u, float* v) {  // 4 fp32
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void bf16_to_f32(uint4 u, float* v) {  // 8 bf16
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  to_f32(load16_stream(p), v);
  to_f32(load16_stream(p + 4), v + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  bf16_to_f32(load16_stream(p), v);
}

// gamma or beta (C,), fp32 or bf16, through L1
__device__ __forceinline__ void load8(const void* p, bool bf16, int i, float (&v)[kVec]) {
  if (bf16) {
    bf16_to_f32(__ldg(static_cast<const uint4*>(p) + i / 8), v);
  } else {
    to_f32(__ldg(static_cast<const uint4*>(p) + i / 4), v);
    to_f32(__ldg(static_cast<const uint4*>(p) + i / 4 + 1), v + 4);
  }
}

// The table's rows (ROPE instantiations): kernel row r belongs to token
// tok = r / tok_rows (tok_rows consecutive rows share one, the heads of
// per-head rows), token (b, s) = (tok / n_tok, tok % n_tok) reads its
// (D / 2, 2, 2) fp32 matrices at freqs + b * s_b + s * s_s, and element c
// of a row is of pair (c % D) / 2.
struct Rope {
  const float* freqs;
  unsigned tok_rows, n_tok;
  long long s_b, s_s;
  int head_dim;
};

// a value as the unfused path hands it on: rounded to the output dtype
__device__ __forceinline__ float rounded(float v, float*) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rotate 8 outputs (4 pairs) by their 4 matrices m = (t00, t01, t10, t11),
// read through L1: out_i = t_i0 * x0 + t_i1 * x1, apply_rope's mul, mul,
// add in fp32
template <typename O>
__device__ __forceinline__ void rope8(float (&y)[kVec], const float* m) {
#pragma unroll
  for (int p = 0; p < kVec / 2; ++p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(m) + p);
    const float x0 = rounded(y[2 * p], static_cast<O*>(nullptr));
    const float x1 = rounded(y[2 * p + 1], static_cast<O*>(nullptr));
    y[2 * p] = __fadd_rn(__fmul_rn(t.x, x0), __fmul_rn(t.y, x1));
    y[2 * p + 1] = __fadd_rn(__fmul_rn(t.z, x0), __fmul_rn(t.w, x1));
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One row per `tpr` threads (threads / tpr rows a block); thread t of a row
// holds the 8-element vectors t, t + tpr, ..., NV of them at most.  ROPE:
// the RMS mode with the rotation by `rope` after the scale (`rope` is the
// last parameter, so the others keep their places).
template <typename X, typename O, int NV, bool ROPE>
__global__ void __launch_bounds__(max_threads(NV))
row_norm_kernel(const X* __restrict__ x, const void* __restrict__ gamma,
                const void* __restrict__ beta, O* __restrict__ out, unsigned n_rows,
                unsigned n_inner, long long s_outer, long long s_inner, int C, bool p_bf16,
                bool rms, float eps, int tpr, Rope rope) {
  const int nvec = C / kVec;
  const int t = threadIdx.x % tpr;
  const unsigned row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < n_rows;
  const X* xr = x;
  if (live) {
    const unsigned outer = row / n_inner;
    xr = x + outer * s_outer + (row - outer * n_inner) * s_inner;
  }

  float v[NV][kVec];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = t + k * tpr;
    if (live && vi < nvec) {
      load8(xr + vi * kVec, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[k][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s1 += v[k][e];
      s2 = fmaf(v[k][e], v[k][e], s2);
    }
  }
  // the row's threads: shuffles within a warp (every lane takes part), then
  // across the warps of a one-row block through shared memory, in order
  for (int off = (tpr < 32 ? tpr : 32) / 2; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (tpr > 32) {  // the row's tpr / 32 warps, from the first
    __shared__ float2 part[32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = make_float2(s1, s2);
    __syncthreads();
    const int w0 = threadIdx.x / tpr * (tpr / 32);
    s1 = s2 = 0.f;
    for (int w = w0; w < w0 + tpr / 32; ++w) {
      s1 += part[w].x;
      s2 += part[w].y;
    }
  }
  if (!live) return;

  const float inv_c = 1.f / C;
  const float mean = rms ? 0.f : s1 * inv_c;
  const float rstd = rsqrtf(fmaf(-mean, mean, s2 * inv_c) + eps);
  O* orow = out + (long long)row * C;
  const float* table = nullptr;  // ROPE: the row's token's matrices
  if constexpr (ROPE) {
    const unsigned tok = row / rope.tok_rows, b = tok / rope.n_tok;
    table = rope.freqs + b * rope.s_b + (tok - b * rope.n_tok) * rope.s_s;
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = t + k * tpr;
    if (vi >= nvec) break;
    float y[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] = (v[k][e] - mean) * rstd;
    if (gamma != nullptr) {
      float g[kVec];
      load8(gamma, p_bf16, vi * kVec, g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] *= g[e];
    }
    if (beta != nullptr) {
      float bb[kVec];
      load8(beta, p_bf16, vi * kVec, bb);
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] += bb[e];
    }
    if constexpr (ROPE) rope8<O>(y, table + vi * kVec % rope.head_dim * 2);
    store8(orow + vi * kVec, y);
  }
}

template <typename X, typename O, int NV, bool ROPE>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* out,
                   unsigned n_rows, unsigned n_inner, long long s_outer, long long s_inner,
                   int C, bool p_bf16, bool rms, float eps, int threads, int tpr,
                   const Rope& rope, cudaStream_t stream) {
  if (threads > max_threads(NV)) return cudaErrorInvalidValue;
  const unsigned rows_per_block = threads / tpr;
  const unsigned blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  row_norm_kernel<X, O, NV, ROPE><<<blocks, threads, 0, stream>>>(
      static_cast<const X*>(x), gamma, beta, static_cast<O*>(out), n_rows, n_inner, s_outer,
      s_inner, C, p_bf16, rms, eps, tpr, rope);
  return cudaGetLastError();
}

template <typename X, typename O, bool ROPE>
cudaError_t launch_nv(int nv, const void* x, const void* gamma, const void* beta, void* out,
                      unsigned n_rows, unsigned n_inner, long long s_outer, long long s_inner,
                      int C, bool p_bf16, bool rms, float eps, int threads, int tpr,
                      const Rope& rope, cudaStream_t stream) {
#define LP_NV(N)                                                                           \
  if (nv <= N)                                                                             \
    return launch<X, O, N, ROPE>(x, gamma, beta, out, n_rows, n_inner, s_outer, s_inner,   \
                                 C, p_bf16, rms, eps, threads, tpr, rope, stream);
  LP_NV(1)
  LP_NV(2)
  LP_NV(4)
  LP_NV(8)
#undef LP_NV
  return cudaErrorInvalidValue;
}

}  // namespace

// x: rows of C elements (C % 8 == 0, C <= 8192), row r at element offset
// (r / n_inner) * s_outer + (r % n_inner) * s_inner, unit stride within a
// row, 16-byte aligned rows; gamma, beta: (C,) or null, both fp32 or both
// bf16 (p_bf16); out: (n_rows, C) contiguous.  x_bf16 / out_bf16: bf16 if
// nonzero, else fp32.  `threads` a block (a multiple of 32, at most 1,024)
// and `tpr` threads a row dividing it (a power of two up to 32, or a
// multiple of 32); tpr * 8 * 8 >= C, and at most 512 threads where a
// thread holds 32 elements or more, 256 where 64.  freqs: null, or the RoPE
// table (`Rope` above; fp32, 16-byte aligned, strides s_b and s_s multiples
// of 4, each (D / 2, 2, 2) matrix block contiguous) for the RMS mode with
// x_bf16 == out_bf16, head_dim D % 8 == 0 dividing C, tok_rows dividing
// n_rows.  Returns a cudaError_t.
extern "C" int lp_row_norm(const void* x, const void* gamma, const void* beta, void* out,
                           long long n_rows, long long n_inner, long long s_outer,
                           long long s_inner, int C, int x_bf16, int p_bf16, int out_bf16,
                           int rms, float eps, int threads, int tpr, const void* freqs,
                           long long tok_rows, long long n_tok, long long s_b, long long s_s,
                           int head_dim, void* stream) {
  const bool tpr_ok = tpr >= 1 && (tpr <= 32 ? (tpr & (tpr - 1)) == 0 : tpr % 32 == 0);
  if (n_rows <= 0 || n_rows >= (1ll << 31) || n_inner <= 0 || C <= 0 || C % kVec ||
      C > 8192 || threads < 32 || threads > 1024 || threads % 32 || !tpr_ok || threads % tpr)
    return (int)cudaErrorInvalidValue;
  const int nvec = C / kVec;
  const int nv = (nvec + tpr - 1) / tpr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows = (unsigned)n_rows, inner = (unsigned)n_inner;
  const Rope rope{static_cast<const float*>(freqs), (unsigned)tok_rows, (unsigned)n_tok, s_b,
                  s_s, head_dim};
  if (freqs != nullptr) {
    if (!rms || x_bf16 != out_bf16 || head_dim <= 0 || head_dim % kVec || C % head_dim ||
        tok_rows <= 0 || n_rows % tok_rows || n_tok <= 0 || s_b < 0 || s_s < 0 || s_b % 4 ||
        s_s % 4 || reinterpret_cast<uintptr_t>(freqs) % 16)
      return (int)cudaErrorInvalidValue;
    if (x_bf16)
      return (int)launch_nv<__nv_bfloat16, __nv_bfloat16, true>(
          nv, x, gamma, beta, out, rows, inner, s_outer, s_inner, C, p_bf16, rms, eps, threads,
          tpr, rope, s);
    return (int)launch_nv<float, float, true>(nv, x, gamma, beta, out, rows, inner, s_outer,
                                              s_inner, C, p_bf16, rms, eps, threads, tpr, rope,
                                              s);
  }
  if (x_bf16 && out_bf16)
    return (int)launch_nv<__nv_bfloat16, __nv_bfloat16, false>(
        nv, x, gamma, beta, out, rows, inner, s_outer, s_inner, C, p_bf16, rms, eps, threads, tpr,
        rope, s);
  if (x_bf16)
    return (int)launch_nv<__nv_bfloat16, float, false>(nv, x, gamma, beta, out, rows, inner,
                                                       s_outer, s_inner, C, p_bf16, rms, eps,
                                                       threads, tpr, rope, s);
  if (out_bf16)
    return (int)launch_nv<float, __nv_bfloat16, false>(nv, x, gamma, beta, out, rows, inner,
                                                       s_outer, s_inner, C, p_bf16, rms, eps,
                                                       threads, tpr, rope, s);
  return (int)launch_nv<float, float, false>(nv, x, gamma, beta, out, rows, inner, s_outer,
                                             s_inner, C, p_bf16, rms, eps, threads, tpr, rope, s);
}
