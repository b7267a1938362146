// Quantized GEMM for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel faster_distributed_training_tpu/ops/quant.py::
// quant_dot_pallas (def :244, pallas_call :272, kernel _quant_matmul_kernel
// :233):
//
//   out[m, n] = cast_out(float(sum_k xq[m, k] * wq[n, k]) * inv),
//   inv = 1.0f / (sx * sw)
//
// with xq [M, K] and wq [N, K] (nn.Linear's (out, in) layout, the JAX
// (K, N) kernel transposed) already quantized.  int8: exact int32 sums, so
// the result equals the plain version bit for bit.  E4M3: see below.  The
// scales arrive as device pointers, so the caller never waits on the card
// for them.
//
// What bounds it on this card: at the record's qkv shape (8192 x 512 ->
// 1536, 8-bit operands, bf16 out) the work is 12.9 GOP against ~30 MB of
// traffic (25 MB of it the bf16 output), 6.5 us at 1,979 TOP/s and 9.0 us
// at 3.35 TB/s: the bytes, barely, so the kernel must reach the 8-bit
// tensor-core rate and write the output in full 16-byte rows.
//
// Design: one templated wgmma GEMM over the 8-bit operand type (s8 with
// s32 accumulators, E4M3 with fp32 accumulators).  One block of two
// consumer warpgroups per 128 x 128 output tile (64 rows each, wgmma
// m64n128k32); both operands are K-major in shared memory (8-bit wgmma has
// no transpose bit, and xq and wq are both K-major already, so no
// transposed copy exists), in 128-byte K slices through a three-stage
// cp.async ring (SwTileB in csrc/sm90.cuh, the swizzle the descriptors
// name).  96 KB of shared memory and at most 128 registers a thread let
// two blocks share an SM, so one block's epilogue overlaps the other's
// loads.  The epilogue descales and casts in registers, stages the tile in
// shared memory and stores it as 16-byte rows.  Edges: rows past M or N
// and bytes past K load as zeros (cp.async with source size 0), so a K with
// K % 32 == 16 zero-fills the last k32 step; the epilogue masks ragged M
// and N.
//
// E4M3 accumulation: Hopper's fp8 wgmma does not add at full fp32
// precision (about 14 bits are kept, DeepSeek-V3 report section 3.3.2):
// one k32 step alone errs by ~7e-5 of max |plain| on this card, and
// promoting partial sums into fp32 registers as often as every k32 step
// still missed the 1e-5 that fp32 output is held to (PERF.md, PR 6).  So
// the C entry picks the E4M3 route by output type:
//   * bf16 output (held to 2e-2; the training and serving path): fp8
//     wgmma, partial sums in the tensor cores at ~14 bits.  It errs by
//     0.0038-0.0057 of max |plain| at the smoke's shapes (PERF.md);
//   * fp32 output (1e-5): the E4M3 operands upcast exactly to bf16 in
//     shared memory and bf16 wgmma k16 with fp32 accumulators, which sum
//     exactly as the plain version does up to order: half the fp8 rate,
//     synchronous loads, one block an SM; it serves the fp32 checks, not
//     the training path.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 128, BN = 128;
constexpr int BK = 128;  // bytes (8-bit values) of K a stage
constexpr int STAGES = 3;
constexpr int NT = 256;  // two warpgroups
using Tile = SwTileB<BK, BM>;
constexpr int STAGE_BYTES = 2 * Tile::BYTES;  // A and B, 32 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + base alignment

enum { FMT_INT8 = 0, FMT_E4M3 = 1 };
using Tile16 = SwTileB<2 * BK, BM>;  // the upcast route's bf16 tiles, 32 KB each

// 16 E4M3 bytes -> 16 bf16 values (exact) as two 16-byte chunks
__device__ __forceinline__ void upcast16(const uint4& v, uint4& lo, uint4& hi) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_fp8_e4m3 x0, x1;
    x0.__x = b[2 * i];
    x1.__x = b[2 * i + 1];
    w[i] = pack_bf16(static_cast<float>(x0), static_cast<float>(x1));
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <int FMT>
struct Engine;
template <>
struct Engine<FMT_INT8> {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db, int acc) {
    WgmmaS8<BN>::ss(d, da, db, acc);
  }
  static __device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
};
template <>
struct Engine<FMT_E4M3> {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    WgmmaE4M3<BN>::ss(d, da, db, acc);
  }
  static __device__ __forceinline__ float to_float(float v) { return v; }
};

// UPCAST: E4M3 operands upcast to bf16 and bf16 wgmma (the fp32-output route)
template <typename T, int FMT, bool UPCAST>
__global__ void __launch_bounds__(NT, UPCAST ? 1 : 2)
    qmm_kernel_sm90(const uint8_t* __restrict__ xq, const uint8_t* __restrict__ wq,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    T* __restrict__ out, int M, int N, int K) {
  using E = Engine<FMT>;
  using Acc = typename E::Acc;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;
  const int nsteps = (K + 31) / 32;

  // K slice kt of A (rows m0..) and B (rows n0..) into its ring stage;
  // one commit group per call, empty past the end
  auto issue = [&](int kt) {
    if (kt < KT) {
      const uint32_t st = base + (kt % STAGES) * STAGE_BYTES;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 2 * BM * (BK / 16) / NT; ++i) {
        const int v = tid + i * NT;
        const bool is_b = v >= BM * (BK / 16);
        const int u = is_b ? v - BM * (BK / 16) : v;
        const int r = u / (BK / 16), c = u % (BK / 16);
        const int g = (is_b ? n0 : m0) + r, k = k0 + 16 * c;
        const bool ok = g < (is_b ? N : M) && k < K;
        const uint8_t* src = (is_b ? wq : xq) + (ok ? (size_t)g * K + k : 0);
        cp_async16(st + (is_b ? Tile::BYTES : 0) + Tile::offset(r, c), src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  if constexpr (UPCAST) {
    // synchronous: 16 E4M3 bytes from global -> 16 bf16 in the stage
    for (int kt = 0; kt < KT; ++kt) {
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 2 * BM * (BK / 16) / NT; ++i) {
        const int v = tid + i * NT;
        const bool is_b = v >= BM * (BK / 16);
        const int u = is_b ? v - BM * (BK / 16) : v;
        const int r = u / (BK / 16), c = u % (BK / 16);
        const int g = (is_b ? n0 : m0) + r, k = k0 + 16 * c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (g < (is_b ? N : M) && k < K)
          val = *reinterpret_cast<const uint4*>((is_b ? wq : xq) + (size_t)g * K + k);
        uint4 lo, hi;
        upcast16(val, lo, hi);
        unsigned char* dst = smem + (is_b ? Tile16::BYTES : 0);
        *reinterpret_cast<uint4*>(dst + Tile16::offset(r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(dst + Tile16::offset(r, 2 * c + 1)) = hi;
      }
      fence_proxy_async();
      __syncthreads();
      const int ns = min(BK / 16, (K - k0) / 16);
      auto mma16 = [&](int ks) {
        Wgmma<BN>::ss(acc, Tile16::kmajor(base, 64 * wg, ks),
                      Tile16::kmajor(base + Tile16::BYTES, 0, ks), 1);
      };
      wgmma_fence();
      if (ns == BK / 16) {
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) mma16(ks);
      } else {
        for (int ks = 0; ks < ns; ++ks) mma16(ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();  // the stage is rewritten next
    }
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();  // slice kt landed (this thread's copies)
      fence_proxy_async();
      __syncthreads();              // ... every thread's; slice kt - 1's stage is free
      const uint32_t a = base + (kt % STAGES) * STAGE_BYTES, b = a + Tile::BYTES;
      const int ns = min(BK / 32, nsteps - kt * (BK / 32));
      wgmma_fence();
      if (ns == BK / 32) {
        // a full slice: no condition between the wgmmas
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
          E::mma(acc, Tile::kmajor(a, 64 * wg, ks), Tile::kmajor(b, 0, ks), 1);
        wgmma_commit();
        issue(kt + STAGES - 1);  // the next slice's copies queue while the tensor cores run
      } else {
        issue(kt + STAGES - 1);
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
          if (ks < ns) E::mma(acc, Tile::kmajor(a, 64 * wg, ks), Tile::kmajor(b, 0, ks), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // every warpgroup is done with the ring: reuse it

  // epilogue: descale + cast in registers, the tile through shared memory
  // (rows padded by 16 bytes), then 16-byte row stores
  constexpr int OP = BN * (int)sizeof(T) + 16;
  const float inv = __fdiv_rn(1.0f, __fmul_rn(sx[0], sw[0]));
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * w + (l >> 2) + 8 * h, c = 8 * j + 2 * (l & 3);
      T* dst = reinterpret_cast<T*>(smem + r * OP) + c;
      dst[0] = from_f<T>(__fmul_rn(E::to_float(acc[4 * j + 2 * h]), inv));
      dst[1] = from_f<T>(__fmul_rn(E::to_float(acc[4 * j + 2 * h + 1]), inv));
    }
  }
  __syncthreads();
  constexpr int EPC = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = BN / EPC;
  const bool vec = ((size_t)N * sizeof(T)) % 16 == 0;
  for (int v = tid; v < BM * CPR; v += NT) {
    const int r = v / CPR, q = v % CPR, m = m0 + r, n = n0 + q * EPC;
    if (m >= M || n >= N) continue;
    const unsigned char* src = smem + r * OP + q * 16;
    T* dst = out + (size_t)m * N + n;
    if (vec && n + EPC <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < EPC && n + e < N; ++e) dst[e] = reinterpret_cast<const T*>(src)[e];
    }
  }
}

template <typename T, int FMT, bool UPCAST>
cudaError_t launch_one(const void* xq, const void* wq, const float* sx, const float* sw,
                       void* out, int M, int N, int K, cudaStream_t s) {
  auto* kern = qmm_kernel_sm90<T, FMT, UPCAST>;
  static int smem_set[FDT_MAX_DEVICES];
  cudaError_t err = smem_attr_once(kern, SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NT, SMEM_BYTES, s>>>(static_cast<const uint8_t*>(xq),
                                    static_cast<const uint8_t*>(wq), sx, sw,
                                    static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fmt: 0 = int8, 1 = E4M3.  out_dtype: 0 = float32, 1 = bfloat16.
// E4M3 to fp32 takes the exact upcast route, E4M3 to bf16 fp8 wgmma (see
// the note at the top).  xq [M, K], wq [N, K] contiguous and 16-byte
// aligned, K % 16 == 0; sx, sw one fp32 each on the device; out [M, N].
int fdt_quant_matmul(const void* xq, const void* wq, const void* sx, const void* sw, void* out,
                     int fmt, int out_dtype, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || (fmt != FMT_INT8 && fmt != FMT_E4M3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(sx);
  const float* b = static_cast<const float*>(sw);
  cudaError_t err;
  if (out_dtype == 1)
    err = fmt == FMT_INT8
              ? launch_one<__nv_bfloat16, FMT_INT8, false>(xq, wq, a, b, out, M, N, K, s)
              : launch_one<__nv_bfloat16, FMT_E4M3, false>(xq, wq, a, b, out, M, N, K, s);
  else
    err = fmt == FMT_INT8 ? launch_one<float, FMT_INT8, false>(xq, wq, a, b, out, M, N, K, s)
                          : launch_one<float, FMT_E4M3, true>(xq, wq, a, b, out, M, N, K, s);
  return (int)err;
}

// dynamic shared memory a block takes (the same for every instantiation)
long long fdt_qmm_smem_bytes() { return (long long)SMEM_BYTES; }

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
