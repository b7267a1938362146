// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel faster_distributed_training_tpu/ops/
// flash_attention.py::_flash_fwd_pallas (kernel body :183).  Same
// function: s = q.k^T / sqrt(D) + key bias (fp32), fp32 row softmax,
// hash dropout on p in the p.v product only (the normaliser l sums the
// undropped p), out = (p.v) / max(l, 1e-30), optional row lse.  The lse
// comes as a head (lse = m + log l, rounded to fp32) and, optionally, its
// low-order tail (lse_lo = (m - lse) + log l): at a fully masked row
// m is near -1e9, where fp32 steps by 64 and log l vanishes from the
// head, so the backward's p = exp((s - lse) - lse_lo) keeps the row
// normalized (the dense VJP's mean-of-V gradient).
//
// What bounds it on this card: at the serving shape (B*H = 64, L = 512,
// D = 64, bf16) the two products are 4.3 GFLOP against ~17 MB of q/k/v/out
// traffic, about 250 FLOP per byte -- near the bf16 ridge (~295), so the
// tensor cores and the byte traffic both matter; probabilities must never
// reach device memory.
//
// Design: one block per (batch*head n, 64-row q tile), four warps of 16 q
// rows each.  K/V stream through shared memory in 64-key tiles with an
// online softmax (running max m and sum l in fp32, an fp32 accumulator in
// shared memory), so the TPU kernel's whole-row VMEM residency becomes
// O(tile) shared memory and any Lk works.  bf16 products run on the
// tensor cores through WMMA (16x16x16, fp32 accumulate); fp32 products
// run on FMA units at full fp32 precision.  Each warp owns its 16 rows in
// every phase (scores, softmax, rescale, p.v), so only the K/V tile loads
// need a block-wide barrier.  q/k/v/out are addressed through (b, h, l)
// strides, so the model hands in slices of its fused qkv projection and
// receives the context in [B, L, H, D] order without transpose copies.
// wgmma/TMA come later; this version is the simple, correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads: 4 warps x 16 q rows

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // fp32 rows get one pad element (conflict-free column walks); bf16 rows
  // get 8 (keeps WMMA's 16-byte ldm and 32-byte tile alignment)
  static constexpr int QS = D + (kF32 ? 1 : 8);    // Q/K/V row stride
  static constexpr int PS = BK + (kF32 ? 1 : 8);   // P row stride
  static constexpr int SS = BK + 4;                // fp32 score row stride
  static constexpr int OS = D + 4;                 // fp32 accumulator stride
  static constexpr size_t bytes =
      (size_t)(BQ * QS + 2 * BK * QS + BQ * PS) * sizeof(T) +
      (size_t)(BQ * SS + BQ * OS + BK) * sizeof(float);
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, Lk] additive key bias, or null
  void* out;
  float* lse;         // [B*H, Lq] or null
  float* lse_lo;      // [B*H, Lq] low-order tail of lse, or null
  long long sq_b, sq_h, sq_l, sk_b, sk_h, sk_l, sv_b, sv_h, sv_l, so_b, so_h, so_l;
  int H, Lq, Lk;
  float scale;
  int dropout;
  uint32_t seed, b0, h0;
  int h_glob;
  uint32_t thresh;
  float keep_scale;
};

// S[16 rows of this warp][BK] = Q K^T
template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss, int warp,
                                       int lane) {
  using L = Tile<T, D>;
  if constexpr (L::kF32) {
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0 = Ks[lane * L::QS + d];
      const float k1 = Ks[(lane + 32) * L::QS + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = Qs[(16 * warp + r) * L::QS + d];
        acc[r][0] = fmaf(qv, k0, acc[r][0]);
        acc[r][1] = fmaf(qv, k1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      Ss[(16 * warp + r) * L::SS + lane] = acc[r][0];
      Ss[(16 * warp + r) * L::SS + lane + 32] = acc[r][1];
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
        wmma::load_matrix_sync(fa, Qs + 16 * warp * L::QS + 16 * kk, L::QS);
        wmma::load_matrix_sync(fb, Ks + 16 * j * L::QS + 16 * kk, L::QS);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(Ss + 16 * warp * L::SS + 16 * j, fc, L::SS,
                              wmma::mem_row_major);
    }
  }
}

// O[16 rows of this warp][D] += P V
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const T* Ps, const T* Vs, float* Os, int warp,
                                              int lane) {
  using L = Tile<T, D>;
  if constexpr (L::kF32) {
    constexpr int TD = (D + 31) / 32;
    float acc[16][TD];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        acc[r][t] = d < D ? Os[(16 * warp + r) * L::OS + d] : 0.f;
      }
    for (int c = 0; c < BK; ++c) {
      float vv[TD];
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        vv[t] = d < D ? Vs[c * L::QS + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = Ps[(16 * warp + r) * L::PS + c];
#pragma unroll
        for (int t = 0; t < TD; ++t) acc[r][t] = fmaf(p, vv[t], acc[r][t]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int d = lane + 32 * t;
        if (d < D) Os[(16 * warp + r) * L::OS + d] = acc[r][t];
      }
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      float* o = Os + 16 * warp * L::OS + 16 * t;
      wmma::load_matrix_sync(fc, o, L::OS, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::load_matrix_sync(fa, Ps + 16 * warp * L::PS + 16 * kk, L::PS);
        wmma::load_matrix_sync(fb, Vs + 16 * kk * L::QS + 16 * t, L::QS);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(o, fc, L::OS, wmma::mem_row_major);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Args a) {
  using L = Tile<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * L::QS;
  T* Vs = Ks + BK * L::QS;
  T* Ps = Vs + BK * L::QS;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * L::PS);
  float* Os = Ss + BQ * L::SS;
  float* bias_s = Os + BQ * L::OS;

  const int n = blockIdx.x;  // flattened b*H + h
  const int q0 = blockIdx.y * BQ;
  const int b = n / a.H, h = n % a.H;
  const T* q = static_cast<const T*>(a.q) + b * a.sq_b + h * a.sq_h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk_b + h * a.sk_h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv_b + h * a.sv_h;
  T* out = static_cast<T*>(a.out) + b * a.so_b + h * a.so_h;
  const float* bias_row = a.bias ? a.bias + (long long)b * a.Lk : nullptr;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T zero = from_f<T>(0.f);
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qr = q0 + r;
    Qs[r * L::QS + d] = qr < a.Lq ? q[qr * a.sq_l + d] : zero;
  }
  for (int i = tid; i < BQ * L::OS; i += NT) Os[i] = 0.f;

  // softmax ownership: thread pair (row, half) keeps row's m and l; the
  // rows of warp w are 16w..16w+15, the same rows its products touch
  const int row = tid >> 1, half = tid & 1;
  float m_i = neg_inf(), l_i = 0.f;
  uint32_t hq = 0;
  if (a.dropout) {
    // dropout stream: fmix(fmix(fmix(seed ^ bh) ^ q_row) ^ k_col) with the
    // GLOBAL bh = (b0 + n / H) * h_glob + h0 + n % H and global q row
    const uint32_t bh = (a.b0 + (uint32_t)(n / a.H)) * (uint32_t)a.h_glob + a.h0 +
                        (uint32_t)(n % a.H);
    hq = fmix32(fmix32(a.seed ^ bh) ^ (uint32_t)(q0 + row));
  }

  for (int k0 = 0; k0 < a.Lk; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D, kc = k0 + c;
      const bool ok = kc < a.Lk;
      Ks[c * L::QS + d] = ok ? k[kc * a.sk_l + d] : zero;
      Vs[c * L::QS + d] = ok ? v[kc * a.sv_l + d] : zero;
    }
    if (tid < BK) {
      const int kc = k0 + tid;
      bias_s[tid] = kc < a.Lk ? (bias_row ? bias_row[kc] : 0.f) : neg_inf();
    }
    __syncthreads();

    scores<T, D>(Qs, Ks, Ss, warp, lane);
    __syncwarp();

    const float* srow = Ss + row * L::SS + half * 32;
    float sv[32];
    float mx = neg_inf();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      // keys past Lk carry bias -inf and drop out of the row entirely
      sv[j] = srow[j] * a.scale + bias_s[half * 32 + j];
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float ls = 0.f;
    T* prow = Ps + row * L::PS + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float e = expf(sv[j] - m_new);
      ls += e;
      float p = e;
      if (a.dropout) {
        const uint32_t hk = fmix32(hq ^ (uint32_t)(k0 + half * 32 + j));
        p = e * (hk < a.thresh ? a.keep_scale : 0.f);
      }
      prow[j] = from_f<T>(p);
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l_i = l_i * corr + ls;
    m_i = m_new;
    float* orow = Os + row * L::OS + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) orow[d] *= corr;
    __syncwarp();

    accumulate_pv<T, D>(Ps, Vs, Os, warp, lane);
    __syncwarp();
  }

  const float l_c = fmaxf(l_i, 1e-30f);
  const int qr = q0 + row;
  if (qr < a.Lq) {
    const float* orow = Os + row * L::OS + half * (D / 2);
    T* dst = out + qr * a.so_l + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) dst[d] = from_f<T>(orow[d] / l_c);
    if (a.lse && half == 0) {
      const float log_l = logf(l_c);
      const float head = m_i + log_l;
      a.lse[(long long)n * a.Lq + qr] = head;
      if (a.lse_lo) a.lse_lo[(long long)n * a.Lq + qr] = (m_i - head) + log_l;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int N, cudaStream_t stream) {
  using L = Tile<T, D>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(N, (a.Lq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int N, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, N, stream);
    case 32: return launch<T, 32>(a, N, stream);
    case 64: return launch<T, 64>(a, N, stream);
    case 128: return launch<T, 128>(a, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  D must be 16, 32, 64 or 128.
// Strides are in elements.
int fdt_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                  void* lse, void* lse_lo, int dtype, int B, int H, int Lq, int Lk, int D,
                  long long sq_b, long long sq_h, long long sq_l, long long sk_b,
                  long long sk_h, long long sk_l, long long sv_b, long long sv_h,
                  long long sv_l, long long so_b, long long so_h, long long so_l,
                  float scale, int dropout, unsigned int seed, unsigned int b0,
                  unsigned int h0, int h_glob, unsigned int thresh, float keep_scale,
                  void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.lse_lo = static_cast<float*>(lse_lo);
  a.sq_b = sq_b; a.sq_h = sq_h; a.sq_l = sq_l;
  a.sk_b = sk_b; a.sk_h = sk_h; a.sk_l = sk_l;
  a.sv_b = sv_b; a.sv_h = sv_h; a.sv_l = sv_l;
  a.so_b = so_b; a.so_h = so_h; a.so_l = so_l;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch_d<__nv_bfloat16>(a, B * H, D, s)
                               : dispatch_d<float>(a, B * H, D, s);
  return (int)err;
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
