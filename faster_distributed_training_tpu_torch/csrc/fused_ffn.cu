// Fused pre-LN FFN sublayer forward for Hopper (sm_90a), plain C ABI for
// ctypes.
//
// Replaces two TPU kernels of faster_distributed_training_tpu/ops/
// fused_ffn.py: _ffn_fwd_pallas (kernel _ffn_kernel :153) and its
// generalized twin _ffn_fwd_pallas2 (kernel _ffn_kernel2 :537) without the
// tp `partial` output.  Per row of h [rows, d]:
//
//   f   = TorchLayerNorm(h) in fp32 (unbiased variance, eps added to the
//         std), cast to the compute dtype T
//   h1  = f . w1^T + b1        (fp32 accumulation)
//   a   = gelu(h1) through the A&S 7.1.26 erf polynomial, hidden hash
//         dropout, cast to T
//   f2  = a . w2^T + b2, connection hash dropout over width d
//   out = cast_T(h + f2)       (residual in fp32)
//
// Under quant (fmt int8 or E4M3) f and a are quantized here at the delayed
// scales sx1 / sx2, the weights arrive quantized, each GEMM descales by
// 1/(sx*sw), casts to T and upcasts (quant_dot's round trip), and the
// kernel emits amax = [max |f|, max |a|] of the T-rounded values.  Blocks
// run in no order on this card, so the amaxes are max-reduced with
// atomicMax on the float bits (non-negative floats order like ints); a max
// is order-free, so two launches still give equal bits.
//
// Dropout: keep element (row, col) iff (fmix32(seed ^ (grow * width + col0
// + col)) >> 16) < t, survivor scale GRID / t in fp32 (ops/dropout.py::
// keep_factor_rows), with the global row grow = (b0 + r / l_loc) * l_glob
// + s0 + r % l_loc; the hidden site's width is dff_glob and col0 = c0.
//
// What bounds it on this card: at the record's training shape (8192 rows,
// 512 -> 1024 -> 512, bf16) the two GEMMs are 17.2 GFLOP against ~19 MB of
// h, out and weights: 17.4 us of bf16 tensor-core time against 5.7 us of
// bytes -- operations.  The TPU kernel keeps both weight matrices in VMEM;
// what this kernel keeps out of device memory is the [rows, d_ff] hidden
// activation and the LN output.
//
// Design: one block per 32-row tile, 8 warps.  LayerNorm one warp per row
// into shared memory; then a loop over d_ff in 64-column chunks: GEMM1
// chunk, GELU / dropout / quantize in the epilogue, the chunk of `a` in
// shared memory, GEMM2 accumulated into a [32 x d] shared accumulator
// (int32 under int8: the sums are exact, the descale comes once at the
// end, as in the TPU kernel's full-width int32 dot).  The loop over d_ff
// removes any envelope in d_ff; d is bounded by shared memory (the
// wrapper asks fdt_ffn_smem_bytes and raises).  GEMM engines: WMMA bf16
// for bf16 (weight fragments straight from global memory, L2-resident),
// WMMA s8 for int8 (operands staged tile-major so every fragment pointer
// is 256-bit aligned), FMA in fp32 for fp32 compute and for E4M3.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 32;   // rows per block
constexpr int CH = 64;   // d_ff columns per chunk
constexpr int NT = 256;  // 8 warps
constexpr int NW = NT / 32;
constexpr int WS1 = 33;  // FMA stage stride, w1 block [64 cols][32 k]
constexpr int WS2 = 65;  // FMA stage stride, w2 block [64 out][64 cols]

enum { FMT_NONE = 0, FMT_INT8 = 1, FMT_E4M3 = 2 };
enum { ENG_BF16 = 0, ENG_S8 = 1, ENG_FMA = 2 };

__host__ __device__ constexpr int engine_of(bool is_bf16, int fmt) {
  return fmt == FMT_INT8 ? ENG_S8 : (fmt == FMT_NONE && is_bf16 ? ENG_BF16 : ENG_FMA);
}

__host__ __device__ inline size_t al128(size_t n) { return (n + 127) & ~(size_t)127; }

// byte offsets into dynamic shared memory and element strides
struct Layout {
  size_t acc, fbuf, hs, ach, ws, total;
  int AS, FS, HS, ACS;
};

__host__ __device__ inline Layout layout(int eng, int d) {
  Layout L;
  size_t o = 0;
  L.AS = d + 4;  // [BM][d] fp32 or int32 GEMM2 accumulator
  L.acc = o;
  o = al128(o + (size_t)BM * L.AS * 4);
  L.fbuf = o;  // GEMM1 A operand: LN output (quantized under quant)
  if (eng == ENG_BF16) {
    L.FS = d + 8;
    o = al128(o + (size_t)BM * L.FS * 2);
  } else if (eng == ENG_S8) {
    L.FS = 16;
    o = al128(o + (size_t)BM * d);
  } else {
    L.FS = d + 1;
    o = al128(o + (size_t)BM * L.FS * 4);
  }
  L.HS = CH + 4;  // GEMM1 chunk result (WMMA engines)
  L.hs = o;
  if (eng != ENG_FMA) o = al128(o + (size_t)BM * L.HS * 4);
  L.ach = o;  // GEMM2 A operand: the chunk of a
  if (eng == ENG_BF16) {
    L.ACS = CH + 8;
    o = al128(o + (size_t)BM * L.ACS * 2);
  } else if (eng == ENG_S8) {
    L.ACS = 16;
    o = al128(o + (size_t)BM * CH);
  } else {
    L.ACS = CH + 1;
    o = al128(o + (size_t)BM * L.ACS * 4);
  }
  L.ws = o;  // weight staging
  if (eng == ENG_S8)
    o = al128(o + (size_t)CH * d);
  else if (eng == ENG_FMA)
    o = al128(o + (size_t)CH * WS2 * 4);
  L.total = o;
  return L;
}

struct Args {
  const void* h;
  const float* ln_s;
  const float* ln_b;
  const void* w1;  // [d_ff, d]: T, int8 or E4M3 bytes
  const void* b1;  // [d_ff] T
  const void* w2;  // [d, d_ff]
  const void* b2;  // [d] T
  void* out;       // [rows, d] T
  float* amax;     // [2], zeroed by the caller; written under quant only
  const float* scales;  // [sx1, sw1, sx2, sw2] on the device, or null
  int rows, d, d_ff;
  uint32_t seed_h, seed_o, b0, s0, c0;
  int l_loc, l_glob, dff_glob;
  uint32_t t_h, t_c;
  float ks_h, ks_c;
  int drop_h, drop_c;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// erf by Abramowitz-Stegun 7.1.26 in the JAX package's op order
// (ops/fused_ffn.py::_erf_f32), no contraction into FMAs
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(p, ax)));
  float poly = __fadd_rn(__fmul_rn(a5, t), a4);
  poly = __fadd_rn(__fmul_rn(poly, t), a3);
  poly = __fadd_rn(__fmul_rn(poly, t), a2);
  poly = __fadd_rn(__fmul_rn(poly, t), a1);
  const float e = expf(__fmul_rn(-ax, ax));
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(__fmul_rn(poly, t), e)));
}

__device__ __forceinline__ float gelu_as(float h) {
  return __fmul_rn(__fmul_rn(0.5f, h),
                   __fadd_rn(1.f, erf_as(__fmul_rn(h, 0.70710677f))));
}

__device__ __forceinline__ float keep(uint32_t seed, uint32_t idx, uint32_t t, float ks) {
  return (fmix32(seed ^ idx) >> 16) < t ? ks : 0.f;
}

__device__ __forceinline__ uint32_t global_row(const Args& a, int r) {
  const uint32_t ru = (uint32_t)r, ll = (uint32_t)a.l_loc;
  return (a.b0 + ru / ll) * (uint32_t)a.l_glob + a.s0 + ru % ll;
}

__device__ __forceinline__ int8_t q_int8(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, s)), -127.f), 127.f);
  return (int8_t)(int)r;
}

// the E4M3 value of v * s (clipped to +-448, one RNE cast) as fp32
__device__ __forceinline__ float q_e4m3(float v, float s) {
  const float x = fminf(fmaxf(__fmul_rn(v, s), -448.f), 448.f);
  __nv_fp8_e4m3 q;
  q.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return static_cast<float>(q);
}

template <typename T, int FMT>
__device__ __forceinline__ float weight_f(const void* w, size_t i) {
  if constexpr (FMT == FMT_E4M3) {
    __nv_fp8_e4m3 q;
    q.__x = static_cast<const uint8_t*>(w)[i];
    return static_cast<float>(q);
  } else {
    return to_f(static_cast<const T*>(w)[i]);
  }
}

// element (r, k) of a row-major int8 matrix stored as 16 x 16 tiles of
// 256 contiguous bytes, `kt` tiles per tile row
__device__ __forceinline__ int tile_off(int r, int k, int kt) {
  return ((r >> 4) * kt + (k >> 4)) * 256 + (r & 15) * 16 + (k & 15);
}

template <typename T, int FMT>
__global__ void __launch_bounds__(NT) ffn_kernel(const Args a) {
  constexpr bool kBF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int ENG = engine_of(kBF, FMT);
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d, d_ff = a.d_ff, KT = d / 16;
  const Layout L = layout(ENG, d);
  float* accf = reinterpret_cast<float*>(smem + L.acc);
  int* acci = reinterpret_cast<int*>(smem + L.acc);
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* h = static_cast<const T*>(a.h);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* b2 = static_cast<const T*>(a.b2);

  float sx1 = 0.f, inv1 = 0.f, sx2 = 0.f, inv2 = 0.f;
  if constexpr (FMT != FMT_NONE) {
    sx1 = a.scales[0];
    inv1 = __fdiv_rn(1.f, __fmul_rn(a.scales[0], a.scales[1]));
    sx2 = a.scales[2];
    inv2 = __fdiv_rn(1.f, __fmul_rn(a.scales[2], a.scales[3]));
  }
  for (int i = tid; i < BM * L.AS; i += NT) acci[i] = 0;  // 0 bits: 0 and 0.0f

  // -- 1. LayerNorm, one warp per row --------------------------------------
  float amax_f = 0.f;
  for (int r = warp; r < BM; r += NW) {
    const int g = row0 + r;
    const bool valid = g < a.rows;
    const T* x = h + (size_t)(valid ? g : 0) * d;
    float mean = 0.f, stdv = 1.f;
    if (valid) {
      float s = 0.f;
      for (int k = lane; k < d; k += 32) s += to_f(x[k]);
      mean = __fdiv_rn(warp_sum(s), (float)d);
      float ss = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float c = __fsub_rn(to_f(x[k]), mean);
        ss = __fadd_rn(ss, __fmul_rn(c, c));
      }
      stdv = __fadd_rn(__fsqrt_rn(__fdiv_rn(warp_sum(ss), (float)(d - 1))), a.eps);
    }
    for (int k = lane; k < d; k += 32) {
      float fv = 0.f;
      if (valid) {
        const float f = __fadd_rn(
            __fmul_rn(a.ln_s[k], __fdiv_rn(__fsub_rn(to_f(x[k]), mean), stdv)), a.ln_b[k]);
        fv = to_f(from_f<T>(f));
        if constexpr (FMT != FMT_NONE) amax_f = fmaxf(amax_f, fabsf(fv));
      }
      if constexpr (ENG == ENG_BF16) {
        reinterpret_cast<__nv_bfloat16*>(smem + L.fbuf)[r * L.FS + k] = __float2bfloat16_rn(fv);
      } else if constexpr (ENG == ENG_S8) {
        reinterpret_cast<int8_t*>(smem + L.fbuf)[tile_off(r, k, KT)] = q_int8(fv, sx1);
      } else {
        reinterpret_cast<float*>(smem + L.fbuf)[r * L.FS + k] =
            FMT == FMT_E4M3 ? q_e4m3(fv, sx1) : fv;
      }
    }
  }

  // -- 2. the loop over d_ff chunks ------------------------------------------
  float amax_a = 0.f;
  const int fr = tid >> 3, fcg = tid & 7;  // FMA engine: row, column group
  for (int cb = 0; cb < d_ff; cb += CH) {
    const int nc = min(CH, d_ff - cb);  // a multiple of 16
    const int nct = nc / 16;
    __syncthreads();

    // the hidden epilogue of element (r, c) of the chunk: acc -> a
    auto hidden = [&](int r, int c, float v) {
      const int g = row0 + r, col = cb + c;
      if constexpr (FMT != FMT_NONE) v = to_f(from_f<T>(__fmul_rn(v, inv1)));
      v = __fadd_rn(v, to_f(b1[col]));
      float act = gelu_as(v);
      if (a.drop_h) {
        const uint32_t idx = global_row(a, g) * (uint32_t)a.dff_glob + a.c0 + (uint32_t)col;
        act = __fmul_rn(act, keep(a.seed_h, idx, a.t_h, a.ks_h));
      }
      const T aT = from_f<T>(act);
      const float av = to_f(aT);
      if constexpr (FMT != FMT_NONE) {
        if (g < a.rows) amax_a = fmaxf(amax_a, fabsf(av));
      }
      if constexpr (ENG == ENG_BF16) {
        reinterpret_cast<__nv_bfloat16*>(smem + L.ach)[r * L.ACS + c] = aT;
      } else if constexpr (ENG == ENG_S8) {
        reinterpret_cast<int8_t*>(smem + L.ach)[tile_off(r, c, CH / 16)] = q_int8(av, sx2);
      } else {
        reinterpret_cast<float*>(smem + L.ach)[r * L.ACS + c] =
            FMT == FMT_E4M3 ? q_e4m3(av, sx2) : av;
      }
    };

    if constexpr (ENG == ENG_FMA) {
      // GEMM1: thread (fr, fcg) owns columns fcg + 8 i of row fr
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      float* ws = reinterpret_cast<float*>(smem + L.ws);
      const float* fb = reinterpret_cast<const float*>(smem + L.fbuf);
      for (int kb = 0; kb < d; kb += 32) {
        __syncthreads();
        for (int v = tid; v < CH * 32; v += NT) {
          const int c = v >> 5, kk = v & 31;
          ws[c * WS1 + kk] = (c < nc && kb + kk < d)
                                 ? weight_f<T, FMT>(a.w1, (size_t)(cb + c) * d + kb + kk)
                                 : 0.f;
        }
        __syncthreads();
        const int kmax = min(32, d - kb);
        for (int kk = 0; kk < kmax; ++kk) {
          const float av = fb[fr * L.FS + kb + kk];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(av, ws[(fcg + 8 * i) * WS1 + kk], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = fcg + 8 * i;
        if (c < nc) hidden(fr, c, acc[i]);
      }
      // GEMM2: the same thread owns outputs (fr, jb + fcg + 8 i)
      const float* ach = reinterpret_cast<const float*>(smem + L.ach);
      for (int jb = 0; jb < d; jb += 64) {
        __syncthreads();
        for (int v = tid; v < 64 * CH; v += NT) {
          const int j = v / CH, c = v % CH;
          ws[j * WS2 + c] = (jb + j < d && c < nc)
                                ? weight_f<T, FMT>(a.w2, (size_t)(jb + j) * d_ff + cb + c)
                                : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int jl = fcg + 8 * i, j = jb + jl;
          if (j < d) {
            float s = accf[fr * L.AS + j];
            for (int c = 0; c < nc; ++c) s = fmaf(ach[fr * L.ACS + c], ws[jl * WS2 + c], s);
            accf[fr * L.AS + j] = s;
          }
        }
      }
    } else {
      // WMMA engines: warp (rt, ct) computes the 16 x 16 GEMM1 tile
      const int rt = warp >> 2, ct = warp & 3;
      int8_t* ws8 = reinterpret_cast<int8_t*>(smem + L.ws);
      if constexpr (ENG == ENG_S8) {
        // w1 rows cb.. as column-major tiles: tile (n / 16, k / 16)
        const int8_t* w1 = static_cast<const int8_t*>(a.w1);
        for (int v = tid; v < nc * KT; v += NT) {
          const int n = v / KT, kt = v % KT;
          *reinterpret_cast<uint4*>(ws8 + ((n >> 4) * KT + kt) * 256 + (n & 15) * 16) =
              *reinterpret_cast<const uint4*>(w1 + (size_t)(cb + n) * d + kt * 16);
        }
        __syncthreads();
      }
      if (ct < nct) {
        if constexpr (ENG == ENG_S8) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, int> fc;
          wmma::fill_fragment(fc, 0);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
          const int8_t* fq = reinterpret_cast<const int8_t*>(smem + L.fbuf);
          for (int kt = 0; kt < KT; ++kt) {
            wmma::load_matrix_sync(fa, fq + (rt * KT + kt) * 256, 16);
            wmma::load_matrix_sync(fb, ws8 + (ct * KT + kt) * 256, 16);
            wmma::mma_sync(fc, fa, fb, fc);
          }
          wmma::store_matrix_sync(reinterpret_cast<int*>(smem + L.hs) + rt * 16 * L.HS + ct * 16,
                                  fc, L.HS, wmma::mem_row_major);
        } else {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
          wmma::fill_fragment(fc, 0.f);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          const __nv_bfloat16* fbf = reinterpret_cast<const __nv_bfloat16*>(smem + L.fbuf);
          const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(a.w1) +
                                    (size_t)(cb + ct * 16) * d;
          for (int k0 = 0; k0 < d; k0 += 16) {
            wmma::load_matrix_sync(fa, fbf + rt * 16 * L.FS + k0, L.FS);
            wmma::load_matrix_sync(fb, w1 + k0, d);
            wmma::mma_sync(fc, fa, fb, fc);
          }
          wmma::store_matrix_sync(reinterpret_cast<float*>(smem + L.hs) + rt * 16 * L.HS + ct * 16,
                                  fc, L.HS, wmma::mem_row_major);
        }
      }
      __syncthreads();
      for (int e = tid; e < BM * nc; e += NT) {
        const int r = e / nc, c = e % nc;
        const float v = ENG == ENG_S8
                            ? __int2float_rn(reinterpret_cast<const int*>(smem + L.hs)[r * L.HS + c])
                            : reinterpret_cast<const float*>(smem + L.hs)[r * L.HS + c];
        hidden(r, c, v);
      }
      if constexpr (ENG == ENG_S8) {
        // w2's columns cb.. as column-major tiles: tile (j / 16, c / 16)
        const int8_t* w2 = static_cast<const int8_t*>(a.w2);
        for (int v = tid; v < d * nct; v += NT) {
          const int j = v / nct, kt = v % nct;
          *reinterpret_cast<uint4*>(ws8 + ((j >> 4) * (CH / 16) + kt) * 256 + (j & 15) * 16) =
              *reinterpret_cast<const uint4*>(w2 + (size_t)j * d_ff + cb + kt * 16);
        }
      }
      __syncthreads();
      // GEMM2: warp w accumulates the [16 x 16] output tiles w, w + 8, ...
      for (int t = warp; t < 2 * KT; t += NW) {
        const int tr = t / KT, jt = t % KT;
        if constexpr (ENG == ENG_S8) {
          int* dst = acci + tr * 16 * L.AS + jt * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, int> fc;
          wmma::load_matrix_sync(fc, dst, L.AS, wmma::mem_row_major);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
          const int8_t* aq = reinterpret_cast<const int8_t*>(smem + L.ach);
          for (int kt = 0; kt < nct; ++kt) {
            wmma::load_matrix_sync(fa, aq + (tr * (CH / 16) + kt) * 256, 16);
            wmma::load_matrix_sync(fb, ws8 + (jt * (CH / 16) + kt) * 256, 16);
            wmma::mma_sync(fc, fa, fb, fc);
          }
          wmma::store_matrix_sync(dst, fc, L.AS, wmma::mem_row_major);
        } else {
          float* dst = accf + tr * 16 * L.AS + jt * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
          wmma::load_matrix_sync(fc, dst, L.AS, wmma::mem_row_major);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          const __nv_bfloat16* abf = reinterpret_cast<const __nv_bfloat16*>(smem + L.ach);
          const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(a.w2) +
                                    (size_t)(jt * 16) * d_ff + cb;
          for (int kt = 0; kt < nct; ++kt) {
            wmma::load_matrix_sync(fa, abf + tr * 16 * L.ACS + kt * 16, L.ACS);
            wmma::load_matrix_sync(fb, w2 + kt * 16, d_ff);
            wmma::mma_sync(fc, fa, fb, fc);
          }
          wmma::store_matrix_sync(dst, fc, L.AS, wmma::mem_row_major);
        }
      }
    }
  }
  __syncthreads();

  // -- 3. b2, connection dropout, residual ---------------------------------------
  T* out = static_cast<T*>(a.out);
  for (int e = tid; e < BM * d; e += NT) {
    const int r = e / d, j = e % d, g = row0 + r;
    if (g >= a.rows) continue;
    float v = ENG == ENG_S8 ? __int2float_rn(acci[r * L.AS + j]) : accf[r * L.AS + j];
    if constexpr (FMT != FMT_NONE) v = to_f(from_f<T>(__fmul_rn(v, inv2)));
    v = __fadd_rn(v, to_f(b2[j]));
    if (a.drop_c) {
      const uint32_t idx = global_row(a, g) * (uint32_t)d + (uint32_t)j;
      v = __fmul_rn(v, keep(a.seed_o, idx, a.t_c, a.ks_c));
    }
    out[(size_t)g * d + j] = from_f<T>(__fadd_rn(to_f(h[(size_t)g * d + j]), v));
  }

  if constexpr (FMT != FMT_NONE) {
    amax_f = warp_max(amax_f);
    amax_a = warp_max(amax_a);
    if (lane == 0) {
      atomicMax(reinterpret_cast<int*>(a.amax), __float_as_int(amax_f));
      atomicMax(reinterpret_cast<int*>(a.amax) + 1, __float_as_int(amax_a));
    }
  }
}

template <typename T, int FMT>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const Layout L = layout(engine_of(std::is_same<T, __nv_bfloat16>::value, FMT), a.d);
  if (L.total > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<T, FMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return err;
  ffn_kernel<T, FMT><<<(a.rows + BM - 1) / BM, NT, L.total, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fmt(const Args& a, int fmt, cudaStream_t s) {
  switch (fmt) {
    case FMT_NONE: return launch<T, FMT_NONE>(a, s);
    case FMT_INT8: return launch<T, FMT_INT8>(a, s);
    case FMT_E4M3: return launch<T, FMT_E4M3>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block needs (dtype 0 = float32, 1 = bfloat16;
// fmt 0 = none, 1 = int8, 2 = E4M3); above 232448 the kernel cannot run.
long long fdt_ffn_smem_bytes(int dtype, int fmt, int d) {
  return (long long)layout(engine_of(dtype == 1, fmt), d).total;
}

// h [rows, d], out [rows, d] in the compute dtype; ln_s, ln_b [d] fp32;
// w1 [d_ff, d], w2 [d, d_ff] in the compute dtype (fmt 0) or quantized
// (int8 / E4M3 bytes); b1 [d_ff], b2 [d] in the compute dtype; amax [2]
// fp32 zeroed; scales [4] fp32 (fmt != 0).  d and d_ff multiples of 16;
// every pointer 32-byte aligned.
int fdt_fused_ffn_fwd(const void* h, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, void* amax,
                      const void* scales, int dtype, int fmt, int rows, int d, int d_ff,
                      unsigned int seed_h, unsigned int seed_o, unsigned int b0, unsigned int s0,
                      unsigned int c0, int l_loc, int l_glob, int dff_glob, unsigned int t_h,
                      float ks_h, int drop_h, unsigned int t_c, float ks_c, int drop_c, float eps,
                      void* stream) {
  if (rows <= 0 || d < 16 || d % 16 || d_ff <= 0 || d_ff % 16 || l_loc <= 0 || l_glob <= 0 ||
      (fmt != FMT_NONE && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.h = h;
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.out = out;
  a.amax = static_cast<float*>(amax);
  a.scales = static_cast<const float*>(scales);
  a.rows = rows;
  a.d = d;
  a.d_ff = d_ff;
  a.seed_h = seed_h;
  a.seed_o = seed_o;
  a.b0 = b0;
  a.s0 = s0;
  a.c0 = c0;
  a.l_loc = l_loc;
  a.l_glob = l_glob;
  a.dff_glob = dff_glob;
  a.t_h = t_h;
  a.t_c = t_c;
  a.ks_h = ks_h;
  a.ks_c = ks_c;
  a.drop_h = drop_h;
  a.drop_c = drop_c;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch_fmt<__nv_bfloat16>(a, fmt, s)
                               : dispatch_fmt<float>(a, fmt, s);
  return (int)err;
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
