// Flash-attention backward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces three TPU functions of faster_distributed_training_tpu/ops/
// flash_attention.py (the third, the long-context _flash_bwd_kblocked
// with its dq_kernel :421 and dkv_kernel :448, is the first's function
// tiled to fit VMEM at any Lk; the two kernels below are that tiling
// already, so they serve it too):
//   * _flash_bwd_pallas_stats (kernel body :757) -- the saved-stats
//     backward: p = exp(s - lse) from the forward's row lse, and
//     delta = sum_d dO*out computed outside the kernel (:809-811);
//   * _flash_bwd_pallas (kernel body :888) -- the recompute backward,
//     whose residuals are the inputs only.  The port's recompute route
//     re-runs the forward kernel (csrc/flash_fwd.cu, emit_lse) to rebuild
//     out and lse and then launches the same two kernels below; m cancels
//     out of p/l, so this computes what the TPU kernel computes per
//     q-block, with the same input-only memory contract.
//
// Per (q tile, k tile), with the keep factor of the forward's hash
// dropout regenerated from (seed, b*H + h, q row, k column):
//   s  = q.k^T * scale + key bias           (fp32; keys past Lk: -inf)
//   p  = exp((s - lse) - lse_lo)  (lse_lo: the forward's low-order lse
//                                   term, 0 when not given; it keeps a
//                                   fully masked row normalized)
//   pt = p * keep,  dp = (dO.v^T) * keep
//   ds = p * (dp - delta) * scale
//   dv += pt^T.dO,  dk += ds^T.q,  dq += ds.k
//
// What bounds it on this card: at the training shape (B*H = 128,
// L = 512, D = 64, bf16) the five products are ~10*N*L^2*D = 21 GFLOP
// (21 us at 989 TFLOP/s) against ~65 MB of q/k/v/out/dO/dq/dk/dv traffic
// (20 us at 3.35 TB/s): both bounds are near the bf16 ridge, so the
// kernel has to keep the score-shaped tiles (s, p, dp, ds) out of device
// memory and keep the tensor cores busy at once.
//
// Design.  Two kernels and no atomics, so gradients are bitwise
// deterministic (the FA-2 deterministic split; the JAX K-blocked backward
// does the same with dq_kernel / dkv_kernel).  The TPU kernels carry dk/dv
// across a sequential grid (pl.when(i > 0) accumulation); on Hopper blocks
// run unordered, so each dk/dv accumulator lives in one block instead:
//   * dkdv kernel: one block per (b*h, 64-key tile); K/V stay in shared
//     memory, the block loops over 64-row q tiles and keeps dk and dv in
//     fp32 shared-memory accumulators;
//   * dq kernel: one block per (b*h, 64-row q tile); loops over k tiles
//     and keeps dq in fp32 shared memory.
// Four warps per block.  Each warp owns 16 q rows for s/dp/ds (the
// elementwise phase reads only its own rows), and in the dkdv kernel 16
// key rows for the transposed products.  bf16 products run on the tensor
// cores through WMMA (16x16x16, fp32 accumulate) with pt and ds rounded
// to bf16 as their operands; fp32 products run on FMA units at full
// precision.  Operands and gradients are addressed through (b, h, l)
// strides, so the fused qkv projection's gradient is written as one
// [B, L, 3, H, D] buffer with no transpose copies.  The score-shaped
// tiles never leave shared memory.  This is the simple, correct version:
// wgmma, TMA and register-resident P are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads: 4 warps x 16 rows

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // fp32 rows get one pad element (conflict-free column walks); bf16 rows
  // get 8 (keeps WMMA's 16-byte ldm and 32-byte tile alignment)
  static constexpr int QS = D + (kF32 ? 1 : 8);    // q/k/v/dO row stride
  static constexpr int PS = BK + (kF32 ? 1 : 8);   // pt/ds row stride
  static constexpr int SS = BK + 4;                // fp32 s/dp row stride
  static constexpr int AS = D + 4;                 // fp32 accumulator stride
  static constexpr size_t op = align128((size_t)64 * QS * sizeof(T));   // one operand tile
  static constexpr size_t pt = align128((size_t)BQ * PS * sizeof(T));   // pt or ds tile
  static constexpr size_t sc = align128((size_t)BQ * SS * sizeof(float));
  static constexpr size_t acc = align128((size_t)64 * AS * sizeof(float));
  static constexpr size_t vec = align128((size_t)64 * sizeof(float));
  // dkdv: K, V, Q, dO | pt, ds | s, dp | dK, dV | lse, lse_lo, delta, bias
  static constexpr size_t dkdv_bytes = 4 * op + 2 * pt + 2 * sc + 2 * acc + 4 * vec;
  // dq: Q, dO, K, V | ds | s, dp | dQ | lse, lse_lo, delta, bias
  static constexpr size_t dq_bytes = 4 * op + pt + 2 * sc + acc + 4 * vec;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B*H, Lq]
  const float* lse_lo;  // [B*H, Lq] or null
  const float* delta;   // [B*H, Lq]
  const float* bias;   // [B, Lk] additive key bias, or null
  void* dq;
  void* dk;
  void* dv;
  long long sq_b, sq_h, sq_l, sk_b, sk_h, sk_l, sv_b, sv_h, sv_l, so_b, so_h, so_l;
  long long sdq_b, sdq_h, sdq_l, sdk_b, sdk_h, sdk_l, sdv_b, sdv_h, sdv_l;
  int H, Lq, Lk;
  float scale;
  int dropout;
  uint32_t seed, b0, h0;
  int h_glob;
  uint32_t thresh;
  float keep_scale;
};

// Out[16 rows of this warp][BK] = A[rows] . B[BK rows]^T
template <typename T, int D>
__device__ __forceinline__ void rows_dot(const T* A, const T* B, float* Out, int warp,
                                         int lane) {
  using L = Tile<T, D>;
  if constexpr (L::kF32) {
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float b0 = B[lane * L::QS + d];
      const float b1 = B[(lane + 32) * L::QS + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float a = A[(16 * warp + r) * L::QS + d];
        acc[r][0] = fmaf(a, b0, acc[r][0]);
        acc[r][1] = fmaf(a, b1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      Out[(16 * warp + r) * L::SS + lane] = acc[r][0];
      Out[(16 * warp + r) * L::SS + lane + 32] = acc[r][1];
    }
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(fa, A + 16 * warp * L::QS + 16 * kk, L::QS);
        wmma::load_matrix_sync(fb, B + 16 * j * L::QS + 16 * kk, L::QS);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(Out + 16 * warp * L::SS + 16 * j, fc, L::SS,
                              wmma::mem_row_major);
    }
  }
}

// Acc[16 rows of this warp][D] += P[rows][64] . B[64][D]
template <typename T, int D>
__device__ __forceinline__ void acc_nn(const T* P, const T* B, float* Acc, int warp, int lane) {
  using L = Tile<T, D>;
  if constexpr (L::kF32) {
    constexpr int TD = (D + 31) / 32;
    float acc[16][TD];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        acc[r][t] = d < D ? Acc[(16 * warp + r) * L::AS + d] : 0.f;
      }
    for (int c = 0; c < 64; ++c) {
      float bv[TD];
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        bv[t] = d < D ? B[c * L::QS + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = P[(16 * warp + r) * L::PS + c];
#pragma unroll
        for (int t = 0; t < TD; ++t) acc[r][t] = fmaf(p, bv[t], acc[r][t]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        if (d < D) Acc[(16 * warp + r) * L::AS + d] = acc[r][t];
      }
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      float* o = Acc + 16 * warp * L::AS + 16 * t;
      wmma::load_matrix_sync(fc, o, L::AS, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {
        wmma::load_matrix_sync(fa, P + 16 * warp * L::PS + 16 * kk, L::PS);
        wmma::load_matrix_sync(fb, B + 16 * kk * L::QS + 16 * t, L::QS);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(o, fc, L::AS, wmma::mem_row_major);
    }
  }
}

// Acc[16 key rows of this warp][D] += sum_q P[q][key] . B[q][D]  (P^T . B)
template <typename T, int D>
__device__ __forceinline__ void acc_tn(const T* P, const T* B, float* Acc, int warp, int lane) {
  using L = Tile<T, D>;
  if constexpr (L::kF32) {
    constexpr int TD = (D + 31) / 32;
    float acc[16][TD];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        acc[r][t] = d < D ? Acc[(16 * warp + r) * L::AS + d] : 0.f;
      }
    for (int q = 0; q < BQ; ++q) {
      float bv[TD];
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        bv[t] = d < D ? B[q * L::QS + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = P[q * L::PS + 16 * warp + r];
#pragma unroll
        for (int t = 0; t < TD; ++t) acc[r][t] = fmaf(p, bv[t], acc[r][t]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        if (d < D) Acc[(16 * warp + r) * L::AS + d] = acc[r][t];
      }
  } else {
    // P^T as a column-major A operand: element (key i, q j) sits at
    // P[(16kk + j) * PS + 16 warp + i]
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      float* o = Acc + 16 * warp * L::AS + 16 * t;
      wmma::load_matrix_sync(fc, o, L::AS, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::load_matrix_sync(fa, P + 16 * kk * L::PS + 16 * warp, L::PS);
        wmma::load_matrix_sync(fb, B + 16 * kk * L::QS + 16 * t, L::QS);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(o, fc, L::AS, wmma::mem_row_major);
    }
  }
}

// rows [r0, r0+64) of a (b, h) slice into a shared tile; rows past n are 0
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long sl, int r0, int n,
                                          int tid) {
  using L = Tile<T, D>;
  const T zero = from_f<T>(0.f);
  for (int i = tid; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, g = r0 + r;
    dst[r * L::QS + d] = g < n ? src[g * sl + d] : zero;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float* src, long long sl, int r0,
                                           int n, int tid) {
  using L = Tile<T, D>;
  for (int i = tid; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, g = r0 + r;
    if (g < n) dst[g * sl + d] = from_f<T>(src[r * L::AS + d]);
  }
}

// the forward's dropout stream for flattened instance n and q row qr:
// fmix(fmix(seed ^ bh) ^ qr) with the GLOBAL bh
__device__ __forceinline__ uint32_t row_hash(const Args& a, int n, int qr) {
  const uint32_t bh = (a.b0 + (uint32_t)(n / a.H)) * (uint32_t)a.h_glob + a.h0 +
                      (uint32_t)(n % a.H);
  return fmix32(fmix32(a.seed ^ bh) ^ (uint32_t)qr);
}

// The elementwise phase of one (q tile, k tile): thread pair (row, half)
// owns 32 columns of q row `row` (a row of its own warp).  Writes ds and,
// when Pt is given, pt.
template <typename T, int D>
__device__ __forceinline__ void grad_scores(const Args& a, int n, int q0, int k0,
                                            const float* Ss, const float* dPs,
                                            const float* lse_s, const float* lo_s,
                                            const float* dl_s,
                                            const float* bias_s, T* Pt, T* dS, int tid) {
  using L = Tile<T, D>;
  const int row = tid >> 1, half = tid & 1;
  const float lse_r = lse_s[row], lo_r = lo_s[row], dl = dl_s[row];
  const uint32_t hq = a.dropout ? row_hash(a, n, q0 + row) : 0u;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int c = half * 32 + j;
    const float s = Ss[row * L::SS + c] * a.scale + bias_s[c];
    const float p = expf((s - lse_r) - lo_r);
    float dp = dPs[row * L::SS + c];
    float pt = p;
    if (a.dropout) {
      const float keep = fmix32(hq ^ (uint32_t)(k0 + c)) < a.thresh ? a.keep_scale : 0.f;
      pt = p * keep;
      dp = dp * keep;
    }
    const float ds = p * (dp - dl) * a.scale;
    if (Pt) Pt[row * L::PS + c] = from_f<T>(pt);
    dS[row * L::PS + c] = from_f<T>(ds);
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_stats(const Args& a, int n, int q0, float* lse_s,
                                           float* lo_s, float* dl_s, int tid) {
  if (tid < BQ) {
    const int qr = q0 + tid;
    const bool ok = qr < a.Lq;
    // rows past Lq get lse = +inf, so p = 0 and they add nothing
    lse_s[tid] = ok ? a.lse[(long long)n * a.Lq + qr] : pos_inf();
    lo_s[tid] = ok && a.lse_lo ? a.lse_lo[(long long)n * a.Lq + qr] : 0.f;
    dl_s[tid] = ok ? a.delta[(long long)n * a.Lq + qr] : 0.f;
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_bias(const Args& a, const float* bias_row, int k0,
                                          float* bias_s, int tid) {
  if (tid < BK) {
    const int kc = k0 + tid;
    // keys past Lk carry bias -inf and drop out of every row
    bias_s[tid] = kc < a.Lk ? (bias_row ? bias_row[kc] : 0.f) : neg_inf();
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(const Args a) {
  using L = Tile<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* Ks = reinterpret_cast<T*>(p); p += L::op;
  T* Vs = reinterpret_cast<T*>(p); p += L::op;
  T* Qs = reinterpret_cast<T*>(p); p += L::op;
  T* dOs = reinterpret_cast<T*>(p); p += L::op;
  T* Pt = reinterpret_cast<T*>(p); p += L::pt;
  T* dS = reinterpret_cast<T*>(p); p += L::pt;
  float* Ss = reinterpret_cast<float*>(p); p += L::sc;
  float* dPs = reinterpret_cast<float*>(p); p += L::sc;
  float* dKa = reinterpret_cast<float*>(p); p += L::acc;
  float* dVa = reinterpret_cast<float*>(p); p += L::acc;
  float* lse_s = reinterpret_cast<float*>(p); p += L::vec;
  float* lo_s = reinterpret_cast<float*>(p); p += L::vec;
  float* dl_s = reinterpret_cast<float*>(p); p += L::vec;
  float* bias_s = reinterpret_cast<float*>(p);

  const int n = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = n / a.H, h = n % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* q = static_cast<const T*>(a.q) + b * a.sq_b + h * a.sq_h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk_b + h * a.sk_h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv_b + h * a.sv_h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.so_b + h * a.so_h;

  load_rows<T, D>(Ks, k, a.sk_l, k0, a.Lk, tid);
  load_rows<T, D>(Vs, v, a.sv_l, k0, a.Lk, tid);
  load_bias<T, D>(a, a.bias ? a.bias + (long long)b * a.Lk : nullptr, k0, bias_s, tid);
  for (int i = tid; i < 64 * L::AS; i += NT) dKa[i] = dVa[i] = 0.f;

  for (int q0 = 0; q0 < a.Lq; q0 += BQ) {
    __syncthreads();  // the previous q tile's products are done with Q/dO/pt/ds
    load_rows<T, D>(Qs, q, a.sq_l, q0, a.Lq, tid);
    load_rows<T, D>(dOs, dout, a.so_l, q0, a.Lq, tid);
    load_stats<T, D>(a, n, q0, lse_s, lo_s, dl_s, tid);
    __syncthreads();
    rows_dot<T, D>(Qs, Ks, Ss, warp, lane);    // s  (this warp's q rows)
    rows_dot<T, D>(dOs, Vs, dPs, warp, lane);  // dp (this warp's q rows)
    __syncwarp();
    grad_scores<T, D>(a, n, q0, k0, Ss, dPs, lse_s, lo_s, dl_s, bias_s, Pt, dS, tid);
    __syncthreads();  // the transposed products read every warp's rows
    acc_tn<T, D>(Pt, dOs, dVa, warp, lane);    // dv += pt^T dO
    acc_tn<T, D>(dS, Qs, dKa, warp, lane);     // dk += ds^T q
  }
  __syncthreads();
  T* dk = static_cast<T*>(a.dk) + b * a.sdk_b + h * a.sdk_h;
  T* dv = static_cast<T*>(a.dv) + b * a.sdv_b + h * a.sdv_h;
  store_rows<T, D>(dk, dKa, a.sdk_l, k0, a.Lk, tid);
  store_rows<T, D>(dv, dVa, a.sdv_l, k0, a.Lk, tid);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(const Args a) {
  using L = Tile<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p); p += L::op;
  T* dOs = reinterpret_cast<T*>(p); p += L::op;
  T* Ks = reinterpret_cast<T*>(p); p += L::op;
  T* Vs = reinterpret_cast<T*>(p); p += L::op;
  T* dS = reinterpret_cast<T*>(p); p += L::pt;
  float* Ss = reinterpret_cast<float*>(p); p += L::sc;
  float* dPs = reinterpret_cast<float*>(p); p += L::sc;
  float* dQa = reinterpret_cast<float*>(p); p += L::acc;
  float* lse_s = reinterpret_cast<float*>(p); p += L::vec;
  float* lo_s = reinterpret_cast<float*>(p); p += L::vec;
  float* dl_s = reinterpret_cast<float*>(p); p += L::vec;
  float* bias_s = reinterpret_cast<float*>(p);

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = n / a.H, h = n % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* q = static_cast<const T*>(a.q) + b * a.sq_b + h * a.sq_h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk_b + h * a.sk_h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv_b + h * a.sv_h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.so_b + h * a.so_h;
  const float* bias_row = a.bias ? a.bias + (long long)b * a.Lk : nullptr;

  load_rows<T, D>(Qs, q, a.sq_l, q0, a.Lq, tid);
  load_rows<T, D>(dOs, dout, a.so_l, q0, a.Lq, tid);
  load_stats<T, D>(a, n, q0, lse_s, lo_s, dl_s, tid);
  for (int i = tid; i < 64 * L::AS; i += NT) dQa[i] = 0.f;

  for (int k0 = 0; k0 < a.Lk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D>(Ks, k, a.sk_l, k0, a.Lk, tid);
    load_rows<T, D>(Vs, v, a.sv_l, k0, a.Lk, tid);
    load_bias<T, D>(a, bias_row, k0, bias_s, tid);
    __syncthreads();
    rows_dot<T, D>(Qs, Ks, Ss, warp, lane);
    rows_dot<T, D>(dOs, Vs, dPs, warp, lane);
    __syncwarp();
    grad_scores<T, D>(a, n, q0, k0, Ss, dPs, lse_s, lo_s, dl_s, bias_s, nullptr, dS, tid);
    __syncwarp();
    acc_nn<T, D>(dS, Ks, dQa, warp, lane);  // dq += ds k (this warp's rows)
  }
  __syncthreads();
  T* dq = static_cast<T*>(a.dq) + b * a.sdq_b + h * a.sdq_h;
  store_rows<T, D>(dq, dQa, a.sdq_l, q0, a.Lq, tid);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int N, cudaStream_t stream) {
  using L = Tile<T, D>;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::dq_bytes);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, D><<<dim3(N, (a.Lk + BK - 1) / BK), NT, L::dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3(N, (a.Lq + BQ - 1) / BQ), NT, L::dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int N, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, N, stream);
    case 32: return launch<T, 32>(a, N, stream);
    case 64: return launch<T, 64>(a, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest head dim the backward takes for dtype (0 = fp32, 1 = bf16): the
// dkdv kernel's shared memory (K, V, Q, dO tiles plus two fp32
// accumulators) outgrows a block's 227 KB for fp32 at D = 128.
int fdt_flash_bwd_max_head_dim(int dtype) { return dtype == 1 ? 128 : 64; }

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse, lse_lo
// (or null) and delta are contiguous [B*H, Lq] fp32; bias is [B, Lk] fp32
// or null.
// Launches the dkdv kernel, then the dq kernel, on `stream`.
int fdt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* lse_lo, const void* delta, const void* bias,
                  void* dq, void* dk,
                  void* dv, int dtype, int B, int H, int Lq, int Lk, int D, long long sq_b,
                  long long sq_h, long long sq_l, long long sk_b, long long sk_h,
                  long long sk_l, long long sv_b, long long sv_h, long long sv_l,
                  long long so_b, long long so_h, long long so_l, long long sdq_b,
                  long long sdq_h, long long sdq_l, long long sdk_b, long long sdk_h,
                  long long sdk_l, long long sdv_b, long long sdv_h, long long sdv_l,
                  float scale, int dropout, unsigned int seed, unsigned int b0,
                  unsigned int h0, int h_glob, unsigned int thresh, float keep_scale,
                  void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.lse_lo = static_cast<const float*>(lse_lo);
  a.delta = static_cast<const float*>(delta);
  a.bias = static_cast<const float*>(bias);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.sq_b = sq_b; a.sq_h = sq_h; a.sq_l = sq_l;
  a.sk_b = sk_b; a.sk_h = sk_h; a.sk_l = sk_l;
  a.sv_b = sv_b; a.sv_h = sv_h; a.sv_l = sv_l;
  a.so_b = so_b; a.so_h = so_h; a.so_l = so_l;
  a.sdq_b = sdq_b; a.sdq_h = sdq_h; a.sdq_l = sdq_l;
  a.sdk_b = sdk_b; a.sdk_h = sdk_h; a.sdk_l = sdk_l;
  a.sdv_b = sdv_b; a.sdv_h = sdv_h; a.sdv_l = sdv_l;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.scale = scale;
  a.dropout = dropout;
  a.seed = seed;
  a.b0 = b0;
  a.h0 = h0;
  a.h_glob = h_glob;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  if (D > fdt_flash_bwd_max_head_dim(dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(a, B * H, s);
    return (int)dispatch_d<__nv_bfloat16>(a, B * H, D, s);
  }
  return (int)dispatch_d<float>(a, B * H, D, s);
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
