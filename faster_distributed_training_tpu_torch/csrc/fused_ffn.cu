// Fused pre-LN FFN sublayer forward for Hopper (sm_90a), plain C ABI for
// ctypes.
//
// Replaces two TPU kernels of faster_distributed_training_tpu/ops/
// fused_ffn.py: _ffn_fwd_pallas (def :208, pallas_call :242, kernel
// _ffn_kernel :153) and its generalized twin _ffn_fwd_pallas2 (:624 /
// :679 / _ffn_kernel2 :537), its tp `partial` mode included.  Per row of
// h [rows, d]:
//
//   f   = TorchLayerNorm(h) in fp32 (unbiased variance, eps added to the
//         std), cast to the compute dtype T
//   h1  = f . w1^T + b1        (fp32 accumulation)
//   a   = gelu(h1) through the A&S 7.1.26 erf polynomial, hidden hash
//         dropout, cast to T
//   f2  = a . w2^T + b2, connection hash dropout over width d
//   out = cast_T(h + f2)       (residual in fp32)
//
// partial (the Megatron column-then-row tile of a tensor-parallel rank):
// w1 is the rank's [d_ff/tp, d] rows and w2 its [d, d_ff/tp] columns, the
// hidden dropout addresses the global columns (c0, dff_glob), and the
// kernel stops before b2: out [rows, d] is fp32 a . w2^T (descaled, and
// under quant rounded to T first, as quant_dot's output is), which the
// caller sums over the tp group before b2, the connection dropout and the
// residual.  Only the epilogue differs; both engines take it.
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
// bytes -- operations (8.7 us at the 8-bit rate under quant).  The TPU
// kernel keeps both weight matrices in VMEM; here they stay in the 50 MB
// L2 and every row block streams them again (2 MB bf16 a block), and what
// the kernel keeps out of device memory is the [rows, d_ff] hidden
// activation and the LN output.
//
// Two engines, routed by shape and type in the C entry (engine_for below,
// which ops/fused_ffn.py::ffn_engine asks), never by a failure:
//
// ffn_kernel_sm90<T, FMT, DH> (bf16 for every fmt, fp32 under quant;
// d_model <= 512): wgmma.  One block per 64-row tile (one wgmma M; 128
// blocks at 8192 rows, one wave on 132 SMs), two consumer warpgroups.
//   * LN: one warp a row, fp32, into a K-major swizzled tile in shared
//     memory (bf16, or quantized to s8 / E4M3 at sx1), resident for the
//     whole block (64 KB bf16 at d 512, 32 KB 8-bit).
//   * A loop over d_ff in 128-column chunks.  GEMM1: each warpgroup
//     computes 64 rows x its 64 columns of the chunk (wgmma m64n64, SS,
//     A the LN tile, B the w1 slice).  The hidden epilogue runs on the
//     accumulator fragments in registers (descale, b1, A&S erf GELU, hash
//     dropout, cast, amax, quantize at sx2) and stores the chunk into a
//     K-major tile that both warpgroups read as GEMM2's A.  GEMM2: each
//     warpgroup accumulates 64 rows x its DH = d/2 output columns (wgmma
//     m64nDH, 128 fp32 or s32 registers at d 512) across every chunk; the
//     int8 sums are exact, descaled once at the end as in the TPU kernel.
//   * w1 and w2 slices stream through a four-stage cp.async ring of 32 KB
//     tiles (w1: 128 rows x 256 bytes of K; w2: 2 DH rows x the bytes of
//     K that fill a stage), in the swizzle the descriptors name
//     (csrc/sm90.cuh, SwTileB).  Blocks walk the chunks from different
//     starting points so they do not all read one weight tile at once.
//     8-bit wgmma has no transpose bit: w1 [d_ff, d] and w2 [d, d_ff]
//     are both K-major already.
//   * Shared memory: 128 KB ring + LN tile + hidden chunk, 209 KB at d
//     512 bf16: one block an SM.  Edges: rows past the end and columns
//     past d / d_ff load as zeros (cp.async with source size 0), padded
//     hidden columns are stored as 0, the last k32 step of a K with
//     K % 32 == 16 is zero-filled; the epilogue masks rows.
//   * E4M3: the partial sums stay in the tensor cores over d (GEMM1) and
//     d_ff (GEMM2): a second accumulator would not fit beside GEMM2's 128
//     registers without spilling.  The FFN is held to 2e-2 of max
//     |plain|; PERF.md has the measured error.
//   * b2, connection dropout and the residual run on GEMM2's fragments.
//
// ffn_kernel<T, FMT> (the WMMA / FMA kernel): fp32 without quant (FMA in fp32,
// held to 1e-4; no tensor-core type keeps that) and every d_model above
// 512, where the two-warpgroup split of d would need more than 255
// registers a thread.  One block per 32-row tile, 8 warps; the GEMM2
// accumulator [32 x d] in shared memory, 64-column chunks of d_ff; WMMA
// bf16 (weight fragments from global memory), WMMA s8 (operands staged
// tile-major), FMA for fp32 and E4M3; d is bounded by shared memory (the
// wrapper asks fdt_ffn_smem_bytes and raises).
//
// Both write amax = [max |f|, max |a|] under quant with atomicMax on the
// float bits: order-free, so two launches give equal bits.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

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
  const uint32_t* seed_h;  // the two dropout seeds on the device (read when
  const uint32_t* seed_o;  // their site is on)
  uint32_t b0, s0, c0;
  int l_loc, l_glob, dff_glob;
  uint32_t t_h, t_c;
  float ks_h, ks_c;
  int drop_h, drop_c;
  float eps;
  int partial;  // out is float [rows, d]: GEMM2's product, no b2 / dropout /
                // residual
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
  // the dropout seeds, read once a block (null when their site is off)
  const uint32_t seed_h = a.drop_h ? __ldg(a.seed_h) : 0u;
  const uint32_t seed_o = a.drop_c ? __ldg(a.seed_o) : 0u;
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
        act = __fmul_rn(act, keep(seed_h, idx, a.t_h, a.ks_h));
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

  // -- 3. b2, connection dropout, residual (partial: the product alone) ---------
  T* out = static_cast<T*>(a.out);
  for (int e = tid; e < BM * d; e += NT) {
    const int r = e / d, j = e % d, g = row0 + r;
    if (g >= a.rows) continue;
    float v = ENG == ENG_S8 ? __int2float_rn(acci[r * L.AS + j]) : accf[r * L.AS + j];
    if constexpr (FMT != FMT_NONE) v = to_f(from_f<T>(__fmul_rn(v, inv2)));
    if (a.partial) {
      static_cast<float*>(a.out)[(size_t)g * d + j] = v;
      continue;
    }
    v = __fadd_rn(v, to_f(b2[j]));
    if (a.drop_c) {
      const uint32_t idx = global_row(a, g) * (uint32_t)d + (uint32_t)j;
      v = __fmul_rn(v, keep(seed_o, idx, a.t_c, a.ks_c));
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
  static int smem_set[FDT_MAX_DEVICES];
  cudaError_t err = smem_attr_once(ffn_kernel<T, FMT>, (int)L.total, smem_set);
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

// ---------------------------------------------------------------------------
// The wgmma engine (bf16 for fmt none; s8 or E4M3 under quant)

namespace sm90 {

constexpr int BM = 64;         // rows a block: one wgmma M
constexpr int CH = 128;        // d_ff columns a chunk: 64 per warpgroup in GEMM1
constexpr int NT = 256;        // two consumer warpgroups
constexpr int STAGES = 4;      // weight-tile ring
constexpr int SLOT = 32768;    // bytes a ring stage
constexpr int W1 = 256;        // bytes of K a GEMM1 tile ([CH rows][256 B])
using Blk64 = SwTileB<128, BM>;  // LN and hidden tiles: [KP / 128][64][128 B]
using Blk1 = SwTileB<128, CH>;   // GEMM1 weight tile: [2][CH][128 B]

template <int FMT>
struct Eng;
template <>
struct Eng<FMT_NONE> {
  using Acc = float;
  static constexpr int ESZ = 2;
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
    Wgmma<N>::ss(d, da, db, acc);
  }
  static __device__ __forceinline__ float f(float v) { return v; }
};
template <>
struct Eng<FMT_INT8> {
  using Acc = int;
  static constexpr int ESZ = 1;
  template <int N>
  static __device__ __forceinline__ void mma(int (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
    WgmmaS8<N>::ss(d, da, db, acc);
  }
  static __device__ __forceinline__ float f(int v) { return __int2float_rn(v); }
};
template <>
struct Eng<FMT_E4M3> {
  using Acc = float;
  static constexpr int ESZ = 1;
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
    WgmmaE4M3<N>::ss(d, da, db, acc);
  }
  static __device__ __forceinline__ float f(float v) { return v; }
};

// GEMM2 weight tile of DP = 2 DH rows (d padded): as many bytes of K as
// fill a stage, at most a chunk's
template <int FMT, int DH>
struct G2 {
  static constexpr int ESZ = Eng<FMT>::ESZ;
  static constexpr int FIT = SLOT / (2 * DH);
  static constexpr int W2 = FIT < CH * ESZ ? FIT : CH * ESZ;
  using Tile = SwTileB<(W2 < 128 ? W2 : 128), 2 * DH>;
};

__host__ __device__ inline int ln_bytes(int esz, int d) {
  return (d * esz + W1 - 1) / W1 * W1;  // a row of the LN tile, K padded
}

constexpr int BIAS_FLOATS = 2 * CH + 512;  // b1 of two chunks, b2 (fp32)

__host__ __device__ inline size_t smem_bytes(int esz, int d) {
  return 1024 + (size_t)STAGES * SLOT + (size_t)BM * ln_bytes(esz, d) + (size_t)BM * CH * esz +
         BIAS_FLOATS * 4;
}

// the 16-byte group of T values at p as fp32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[16 / sizeof(T)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(b[e]);
  }
}

// one byte (8-bit engines) of the quantized value v * s
template <int FMT>
__device__ __forceinline__ uint8_t q_byte(float v, float s) {
  if constexpr (FMT == FMT_INT8) {
    return (uint8_t)q_int8(v, s);
  } else {
    const float x = fminf(fmaxf(__fmul_rn(v, s), -448.f), 448.f);
    return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  }
}

// the ring's position: the k-th chunk of d_ff this block walks, GEMM1
// (g2 = 0) or GEMM2 tile kt of it.  Every block walks the chunks in the
// same order, so GEMM2 sums a row's chunks in one order wherever the row
// is launched: a row's output depends on the row (and its global index),
// never on its block, and a shard of the rows (a batch origin b0, a
// sequence half at s0) is bitwise the full launch's rows
struct Cursor {
  int k, g2, kt;
  __device__ __forceinline__ int cb() const { return k * CH; }
  __device__ __forceinline__ void advance(int n1, int d_ff, int esz, int w2) {
    if (!g2) {
      if (++kt == n1) g2 = 1, kt = 0;
    } else {
      const int nc = min(CH, d_ff - cb());
      if (++kt == (nc * esz + w2 - 1) / w2) g2 = 0, kt = 0, ++k;
    }
  }
};

template <typename T, int FMT, int DH>
__global__ void __launch_bounds__(NT, 1) ffn_kernel_sm90(const Args a) {
  using E = Eng<FMT>;
  using Acc = typename E::Acc;
  using G = G2<FMT, DH>;
  using Tile2 = typename G::Tile;
  constexpr int ESZ = E::ESZ, W2 = G::W2;
  static_assert(FMT != FMT_NONE || std::is_same<T, __nv_bfloat16>::value,
                "fmt none runs the bf16 engine");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const int d = a.d, d_ff = a.d_ff, KP = ln_bytes(ESZ, d);
  // the dropout seeds, read once a block (null when their site is off)
  const uint32_t seed_h = a.drop_h ? __ldg(a.seed_h) : 0u;
  const uint32_t seed_o = a.drop_c ? __ldg(a.seed_o) : 0u;
  const uint32_t lnt = ring + STAGES * SLOT;      // LN output [64][KP]
  const uint32_t hid = lnt + BM * KP;              // hidden chunk [64][CH * ESZ]
  unsigned char* ln_p = smem_raw + (lnt - raw);
  unsigned char* hid_p = smem_raw + (hid - raw);
  // b1 of the current and the next chunk, and b2, in fp32
  float* bias1 = reinterpret_cast<float*>(hid_p + BM * CH * ESZ);
  float* bias2 = bias1 + 2 * CH;

  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, w = warp & 3, l = tid & 31;
  const T* h = static_cast<const T*>(a.h);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* b2 = static_cast<const T*>(a.b2);
  const unsigned char* w1 = static_cast<const unsigned char*>(a.w1);
  const unsigned char* w2 = static_cast<const unsigned char*>(a.w2);
  const int n1 = (d * ESZ + W1 - 1) / W1;
  const int nch = (d_ff + CH - 1) / CH;

  // the weight tile at cursor c into ring stage s (one commit group a call)
  auto issue = [&](const Cursor& c, int s) {
    if (c.k < nch) {
      const uint32_t st = ring + s * SLOT;
      const int cb = c.cb();
      if (!c.g2) {
        // w1 rows cb .. cb + CH - 1, bytes kt W1 ..
        for (int v = tid; v < CH * (W1 / 16); v += NT) {
          const int n = v / (W1 / 16), q = v % (W1 / 16);
          const int kb = c.kt * W1 + 16 * q;
          const bool ok = cb + n < d_ff && kb < d * ESZ;
          cp_async16(st + Blk1::offset(n, q), w1 + (ok ? (size_t)(cb + n) * d * ESZ + kb : 0),
                     ok ? 16 : 0);
        }
      } else {
        // w2 rows 0 .. 2 DH - 1, bytes (cb .. cb + nc) ESZ of each
        const int lim = min(CH, d_ff - cb) * ESZ;
        for (int v = tid; v < 2 * DH * (W2 / 16); v += NT) {
          const int j = v / (W2 / 16), q = v % (W2 / 16);
          const int kb = c.kt * W2 + 16 * q;
          const bool ok = j < d && kb < lim;
          cp_async16(st + Tile2::offset(j, q),
                     w2 + (ok ? (size_t)j * d_ff * ESZ + (size_t)cb * ESZ + kb : 0),
                     ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  Cursor pc{0, 0, 0};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue(pc, s);
    pc.advance(n1, d_ff, ESZ, W2);
  }

  // b1 of the first chunk and b2 (the next chunks' b1 load during the
  // GEMM2 tiles before them; a barrier always lies between)
  auto load_b1 = [&](int k, int buf) {
    if (tid < CH) {
      const int col = Cursor{k, 0, 0}.cb() + tid;
      bias1[buf * CH + tid] = col < d_ff ? to_f(b1[col]) : 0.f;
    }
  };
  load_b1(0, 0);
  for (int j = tid; j < d; j += NT) bias2[j] = to_f(b2[j]);

  float sx1 = 0.f, inv1 = 0.f, sx2 = 0.f, inv2 = 0.f;
  if constexpr (FMT != FMT_NONE) {
    sx1 = a.scales[0];
    inv1 = __fdiv_rn(1.f, __fmul_rn(a.scales[0], a.scales[1]));
    sx2 = a.scales[2];
    inv2 = __fdiv_rn(1.f, __fmul_rn(a.scales[2], a.scales[3]));
  }

  // -- 1. LayerNorm, one warp per row, the row in registers (16-byte
  //       loads), into the K-major LN tile (zeros past d and for rows past
  //       the end) ----------------------------------------------------------------
  float amax_f = 0.f;
  constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte load
  constexpr int MAXC = 512 / VEC / 32;        // such groups a lane at d <= 512
  const int ngroups = d / VEC;
  for (int r = warp; r < BM; r += NT / 32) {
    const int g = row0 + r;
    const bool valid = g < a.rows;
    float x[MAXC][VEC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = l + 32 * i;
      if (valid && c < ngroups) {
        load16<T>(h + (size_t)g * d + c * VEC, x[i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += x[i][e];
      }
    }
    float mean = 0.f, stdv = 1.f;
    if (valid) {
      mean = __fdiv_rn(warp_sum(s), (float)d);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        if (l + 32 * i < ngroups) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float c = __fsub_rn(x[i][e], mean);
            ss = __fadd_rn(ss, __fmul_rn(c, c));
          }
        }
      }
      stdv = __fadd_rn(__fsqrt_rn(__fdiv_rn(warp_sum(ss), (float)(d - 1))), a.eps);
    }
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = l + 32 * i;
      if (c >= ngroups) continue;
      float fv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        fv[e] = 0.f;
        if (valid) {
          const int k = c * VEC + e;
          const float f = __fadd_rn(
              __fmul_rn(a.ln_s[k], __fdiv_rn(__fsub_rn(x[i][e], mean), stdv)), a.ln_b[k]);
          fv[e] = to_f(from_f<T>(f));
          if constexpr (FMT != FMT_NONE) amax_f = fmaxf(amax_f, fabsf(fv[e]));
        }
      }
      if constexpr (FMT == FMT_NONE) {
        // 8 bf16: one 16-byte chunk of the tile
        *reinterpret_cast<uint4*>(ln_p + Blk64::offset(r, c)) =
            make_uint4(pack_bf16(fv[0], fv[1]), pack_bf16(fv[2], fv[3]), pack_bf16(fv[4], fv[5]),
                       pack_bf16(fv[6], fv[7]));
      } else {
        uint32_t q[VEC / 4];
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4)
          q[e4] = (uint32_t)q_byte<FMT>(fv[4 * e4], sx1) |
                  ((uint32_t)q_byte<FMT>(fv[4 * e4 + 1], sx1) << 8) |
                  ((uint32_t)q_byte<FMT>(fv[4 * e4 + 2], sx1) << 16) |
                  ((uint32_t)q_byte<FMT>(fv[4 * e4 + 3], sx1) << 24);
        if constexpr (VEC == 8)
          *reinterpret_cast<uint2*>(ln_p + Blk64::byte(r, c * VEC)) = make_uint2(q[0], q[1]);
        else
          *reinterpret_cast<uint32_t*>(ln_p + Blk64::byte(r, c * VEC)) = q[0];
      }
    }
  }
  // K padding of the LN tile: zeros from byte d * ESZ to KP of every row
  for (int v = tid; v < BM * ((KP - d * ESZ) / 16); v += NT) {
    const int per = (KP - d * ESZ) / 16, r = v / per, q = d * ESZ / 16 + v % per;
    *reinterpret_cast<uint4*>(ln_p + Blk64::offset(r, q)) = make_uint4(0u, 0u, 0u, 0u);
  }

  // -- 2. the ring: per chunk, GEMM1 tiles then GEMM2 tiles --------------------
  // this thread's two fragment rows (16 w + l / 4 and + 8) and their
  // global ids, the dropout hash's row term
  uint32_t grow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) grow[hh] = global_row(a, row0 + 16 * w + (l >> 2) + 8 * hh);
  Acc acc1[32], acc2[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc2[i] = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = 0;
  float amax_a = 0.f;
  Cursor cc{0, 0, 0};
  for (int t = 0; cc.k < nch; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t landed (this thread's copies)
    fence_proxy_async();          // ... and this thread's st.shared writes
    __syncthreads();              // every thread's; stage (t - 1) % STAGES is free
    // the next weight tile's loads are issued after this tile's wgmmas, so
    // the tensor cores run while the threads queue the copies
    auto refill = [&]() {
      issue(pc, (t + STAGES - 1) % STAGES);
      pc.advance(n1, d_ff, ESZ, W2);
    };
    const uint32_t st = ring + (t % STAGES) * SLOT;
    const int cb = cc.cb(), nc = min(CH, d_ff - cb);
    if (!cc.g2) {
      // GEMM1: this warpgroup's 64 columns of the chunk, K slice kt
      const int ns = min(W1 / 32, (d * ESZ - cc.kt * W1 + 31) / 32);
      auto g1 = [&](int ks) {
        E::template mma<64>(acc1, Blk64::kmajor(lnt, 0, cc.kt * (W1 / 32) + ks),
                            Blk1::kmajor(st, 64 * wg, ks), (cc.kt | ks) != 0);
      };
      wgmma_fence();
      if (ns == W1 / 32) {  // a full tile: no condition between the wgmmas
#pragma unroll
        for (int ks = 0; ks < W1 / 32; ++ks) g1(ks);
      } else {
        for (int ks = 0; ks < ns; ++ks) g1(ks);
      }
      wgmma_commit();
      refill();
      wgmma_wait<0>();
      fence_regs(acc1);
      if (cc.kt == n1 - 1) {
        // the hidden epilogue on the fragments: descale, b1, GELU, dropout,
        // cast, amax, quantize; the chunk into the K-major hidden tile
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * w + (l >> 2) + 8 * hh, g = row0 + r;
            const int c = 64 * wg + 8 * j + 2 * (l & 3);
            float av[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              av[e] = 0.f;
              if (c + e < nc) {
                const int col = cb + c + e;
                float v = E::f(acc1[4 * j + 2 * hh + e]);
                if constexpr (FMT != FMT_NONE) v = to_f(from_f<T>(__fmul_rn(v, inv1)));
                v = __fadd_rn(v, bias1[(cc.k & 1) * CH + c + e]);
                float act = gelu_as(v);
                if (a.drop_h) {
                  const uint32_t idx = grow[hh] * (uint32_t)a.dff_glob + a.c0 + (uint32_t)col;
                  act = __fmul_rn(act, keep(seed_h, idx, a.t_h, a.ks_h));
                }
                av[e] = to_f(from_f<T>(act));
                if constexpr (FMT != FMT_NONE) {
                  if (g < a.rows) amax_a = fmaxf(amax_a, fabsf(av[e]));
                }
              }
            }
            if constexpr (FMT == FMT_NONE) {
              *reinterpret_cast<uint32_t*>(hid_p + Blk64::byte(r, 2 * c)) = pack_bf16(av[0], av[1]);
            } else {
              const uint16_t pair = (uint16_t)q_byte<FMT>(av[0], sx2) |
                                    ((uint16_t)q_byte<FMT>(av[1], sx2) << 8);
              *reinterpret_cast<uint16_t*>(hid_p + Blk64::byte(r, c)) = pair;
            }
          }
        }
      }
    } else {
      // GEMM2: out[64 x this warpgroup's DH columns] += a_chunk . w2 slice
      if (cc.kt == 0 && cc.k + 1 < nch) load_b1(cc.k + 1, (cc.k + 1) & 1);
      const int ns = min(W2 / 32, (nc * ESZ - cc.kt * W2 + 31) / 32);
      auto g2 = [&](int ks) {
        E::template mma<DH>(acc2, Blk64::kmajor(hid, 0, cc.kt * (W2 / 32) + ks),
                            Tile2::kmajor(st, DH * wg, ks), 1);
      };
      wgmma_fence();
      if (ns == W2 / 32) {
#pragma unroll
        for (int ks = 0; ks < W2 / 32; ++ks) g2(ks);
      } else {
        for (int ks = 0; ks < ns; ++ks) g2(ks);
      }
      wgmma_commit();
      refill();
      wgmma_wait<0>();
      fence_regs(acc2);
    }
    cc.advance(n1, d_ff, ESZ, W2);
  }
  cp_async_wait<0>();

  // -- 3. b2, connection dropout, residual, from the fragments (partial: the
  //    fp32 product alone) ------------------------------------------------------
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * w + (l >> 2) + 8 * hh, g = row0 + r;
      const int col = DH * wg + 8 * j + 2 * (l & 3);
      if (g >= a.rows || col >= d) continue;
      if (a.partial) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = E::f(acc2[4 * j + 2 * hh + e]);
          if constexpr (FMT != FMT_NONE) p[e] = to_f(from_f<T>(__fmul_rn(p[e], inv2)));
        }
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + (size_t)g * d + col) =
            make_float2(p[0], p[1]);
        continue;
      }
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = E::f(acc2[4 * j + 2 * hh + e]);
        if constexpr (FMT != FMT_NONE) v = to_f(from_f<T>(__fmul_rn(v, inv2)));
        v = __fadd_rn(v, bias2[col + e]);
        if (a.drop_c) {
          const uint32_t idx = grow[hh] * (uint32_t)d + (uint32_t)(col + e);
          v = __fmul_rn(v, keep(seed_o, idx, a.t_c, a.ks_c));
        }
        o[e] = __fadd_rn(to_f(h[(size_t)g * d + col + e]), v);
      }
      T* dst = out + (size_t)g * d + col;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[0], o[1]);
      }
    }
  }

  if constexpr (FMT != FMT_NONE) {
    amax_f = warp_max(amax_f);
    amax_a = warp_max(amax_a);
    if (l == 0) {
      atomicMax(reinterpret_cast<int*>(a.amax), __float_as_int(amax_f));
      atomicMax(reinterpret_cast<int*>(a.amax) + 1, __float_as_int(amax_a));
    }
  }
}

template <typename T, int FMT, int DH>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes(Eng<FMT>::ESZ, a.d);
  if (bytes > 232448) return cudaErrorInvalidValue;
  static int smem_set[FDT_MAX_DEVICES];
  cudaError_t err = smem_attr_once(ffn_kernel_sm90<T, FMT, DH>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  ffn_kernel_sm90<T, FMT, DH><<<(a.rows + BM - 1) / BM, NT, bytes, s>>>(a);
  return cudaGetLastError();
}

// the narrowest warpgroup width that holds half of d (d <= 512)
template <typename T, int FMT>
cudaError_t launch_d(const Args& a, cudaStream_t s) {
  if (a.d <= 64) return launch<T, FMT, 32>(a, s);
  if (a.d <= 128) return launch<T, FMT, 64>(a, s);
  if (a.d <= 256) return launch<T, FMT, 128>(a, s);
  if (a.d <= 512) return launch<T, FMT, 256>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace sm90

// The routing rule, by shape and type alone: the wgmma kernel (engine 1)
// takes bf16 for every fmt and fp32 under quant up to d_model 512 (its two
// warpgroups split d, and a 64 x 256 fp32 accumulator a warpgroup is 128
// registers a thread); engine 0, the WMMA / FMA kernel above, takes the
// rest.
inline int engine_for(bool is_bf16, int fmt, int d) {
  return d <= 512 && (is_bf16 || fmt != FMT_NONE) ? 1 : 0;
}

cudaError_t dispatch_sm90(const Args& a, bool is_bf16, int fmt, cudaStream_t s) {
  if (is_bf16) {
    switch (fmt) {
      case FMT_NONE: return sm90::launch_d<__nv_bfloat16, FMT_NONE>(a, s);
      case FMT_INT8: return sm90::launch_d<__nv_bfloat16, FMT_INT8>(a, s);
      case FMT_E4M3: return sm90::launch_d<__nv_bfloat16, FMT_E4M3>(a, s);
    }
  } else {
    switch (fmt) {
      case FMT_INT8: return sm90::launch_d<float, FMT_INT8>(a, s);
      case FMT_E4M3: return sm90::launch_d<float, FMT_E4M3>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The kernel a shape runs on (dtype 0 = float32, 1 = bfloat16; fmt 0 =
// none, 1 = int8, 2 = E4M3): 1 = the wgmma kernel, 0 = the WMMA / FMA one.
int fdt_ffn_engine(int dtype, int fmt, int d) { return engine_for(dtype == 1, fmt, d); }

// Dynamic shared memory a block of that kernel needs; above 232448 it
// cannot run.
long long fdt_ffn_smem_bytes(int dtype, int fmt, int d) {
  if (engine_for(dtype == 1, fmt, d))
    return (long long)sm90::smem_bytes(fmt == FMT_NONE ? 2 : 1, d);
  return (long long)layout(engine_of(dtype == 1, fmt), d).total;
}

// h [rows, d], out [rows, d] in the compute dtype (fp32 under partial); ln_s,
// ln_b [d] fp32;
// w1 [d_ff, d], w2 [d, d_ff] in the compute dtype (fmt 0) or quantized
// (int8 / E4M3 bytes); b1 [d_ff], b2 [d] in the compute dtype; amax [2]
// fp32 zeroed; scales [4] fp32 (fmt != 0); seed_h, seed_o the two dropout
// seeds, u32s on the device (null where the site is off), read by the
// kernel so a captured graph replays with the values they hold then.  d
// and d_ff multiples of 16; every pointer 32-byte aligned.  partial: the tp
// tile (w1 / w2 a rank's d_ff shard), out the fp32 GEMM2 product.
int fdt_fused_ffn_fwd(const void* h, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, void* amax,
                      const void* scales, int dtype, int fmt, int rows, int d, int d_ff,
                      const void* seed_h, const void* seed_o, unsigned int b0, unsigned int s0,
                      unsigned int c0, int l_loc, int l_glob, int dff_glob, unsigned int t_h,
                      float ks_h, int drop_h, unsigned int t_c, float ks_c, int drop_c, float eps,
                      int partial, void* stream) {
  if (rows <= 0 || d < 16 || d % 16 || d_ff <= 0 || d_ff % 16 || l_loc <= 0 || l_glob <= 0 ||
      (fmt != FMT_NONE && scales == nullptr) || (drop_h && seed_h == nullptr) ||
      (drop_c && seed_o == nullptr))
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
  a.seed_h = static_cast<const uint32_t*>(seed_h);
  a.seed_o = static_cast<const uint32_t*>(seed_o);
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
  a.partial = partial != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine_for(dtype == 1, fmt, d)) return (int)dispatch_sm90(a, dtype == 1, fmt, s);
  cudaError_t err = dtype == 1 ? dispatch_fmt<__nv_bfloat16>(a, fmt, s)
                               : dispatch_fmt<float>(a, fmt, s);
  return (int)err;
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
