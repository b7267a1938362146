// Fused classifier MLP forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel faster_distributed_training_tpu/ops/
// fused_mlp.py::_mlp_fwd_pallas (kernel _mlp_kernel :93): per row,
// h = x.w1^T + b1 with fp32 accumulation, relu(h) cast to x's dtype,
// out = a.w2^T + b2 in fp32, cast once.  Weights are (out, in), so each
// hidden unit is one contiguous dot product.
//
// What bounds it on this card: at the serving and training shapes (8 or
// 16 rows x 512 -> 1024 -> 4, bf16) the work is 8-17 MFLOP against the
// 1 MB w1 read -- ~0.3 us at 3.35 TB/s, below what any launch takes.  So
// the kernel is held by latency: how many SMs pull w1 at once, how many
// dependent steps a block takes, and the cross-block sum.  At thousands
// of rows it becomes a GEMM (4.3 GFLOP at 4096 rows) and needs the tensor
// cores.
//
// Design, bf16: mlp_fwd_kernel_mma<BIG>, layer 1 on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate).  d_in is cut into KS = 8 slices;
// each slice is one mma chain from zero, and h sums the slices in order
// 0..7.  Units form chunks of 8 (one mma n-tile) and groups of 8 chunks.
//   * BIG = false (up to 64 rows, serving and training): one block per
//     (16 rows, chunk) -- 128 blocks at d_h 1024, so w1 streams through
//     128 SMs -- and one warp per slice, its fragments loaded from device
//     memory straight into registers, every load issued before the
//     products; the slices meet in shared memory.  w2's, b1's and b2's
//     values are loaded at the start and land behind the products.
//   * BIG = true (more rows): one block per (128 rows, group), one warp
//     per 16 rows running the slices one after another, x and w1 staged
//     in shared memory by 16-byte cp.async (a fragment read straight from
//     device memory touches 8 cache lines).
// Both relu and round h to x's dtype and sum layer 2 per chunk (a fixed
// fmaf chain over its 8 units) and per group (the chunks in order), so a
// hidden unit meets the same arithmetic in either.  Each block writes its
// fp32 partials (chunk sums, or group sums) to scratch; the last block of
// a row block to finish (an acq_rel ticket, reset by that block) loads
// them with coalesced reads and sums each output's groups in order.  A
// row's logits depend on nothing but that row: not on the other rows of
// its batch, its position, or which kernel ran it.
//
// fp32 (correctness checks only) keeps the FMA kernel mlp_fwd_kernel:
// blocks of 8 rows x 32 hidden units, 8 warps of 4 units, the last block
// summing the 32-unit splits in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 256;  // 8 warps

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

using bf16 = __nv_bfloat16;
constexpr int KS = 8;          // d_in slices, one mma chain each
constexpr int CH = 8;          // hidden units a chunk (one n-tile)
constexpr int GRP = 8;         // chunks a group
constexpr int SMALL_ROWS = 64; // the BIG = false kernel takes up to this many rows

template <bool BIG>
struct Mma {
  static constexpr int ROWS = BIG ? 128 : 16;       // rows a block
  static constexpr int UNITS = BIG ? CH * GRP : CH; // hidden units a block
};

constexpr int KB = 4;          // k steps whose loads issue before their products

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 at row r, column k of a [n, ld] matrix, 0 past n rows or ld
// columns (ld % 8 == 0, so a pair is all in or all out)
__device__ __forceinline__ uint32_t pair(const bf16* m, int r, int n, int k, int ld) {
  return r < n && k < ld ? *reinterpret_cast<const uint32_t*>(m + (size_t)r * ld + k) : 0u;
}

// acc = the mma chain over k steps [ks0, ks1) of x rows r0 .. r0 + 15 and
// units u0 .. u0 + 7, from zero; fragments loaded from device memory
// straight into registers
__device__ __forceinline__ void slice_chain(float (&acc)[4], const bf16* x, const bf16* w1,
                                           int rows, int d_in, int d_h, int r0, int u0,
                                           int ks0, int ks1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f;
  for (int kb = ks0; kb < ks1; kb += KB) {
    uint32_t a[KB][4], b[KB][2];
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      const int k = 16 * (kb + s) + 2 * t;
      const bool in = kb + s < ks1;
      a[s][0] = in ? pair(x, r0 + g, rows, k, d_in) : 0u;
      a[s][1] = in ? pair(x, r0 + g + 8, rows, k, d_in) : 0u;
      a[s][2] = in ? pair(x, r0 + g, rows, k + 8, d_in) : 0u;
      a[s][3] = in ? pair(x, r0 + g + 8, rows, k + 8, d_in) : 0u;
      b[s][0] = in ? pair(w1, u0 + g, d_h, k, d_in) : 0u;
      b[s][1] = in ? pair(w1, u0 + g, d_h, k + 8, d_in) : 0u;
    }
#pragma unroll
    for (int s = 0; s < KB; ++s)
      if (kb + s < ks1) mma_bf16(acc, a[s], b[s][0], b[s][1]);
  }
}

// The BIG kernel's chain: slice_chain's mma chain for 8 n-tiles and this
// warp's 16 rows, its operands staged in shared memory 4 k steps at a time
// by 16-byte cp.async with zero fill (x rows r0 .. r0 + 127 in xs, w1 rows
// u0 .. u0 + 63 in ws), rows padded to SLD columns so the fragment reads
// meet no bank conflict.
constexpr int SLD = 72;   // staged row stride (bf16): 64 columns + 8

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void slice_chain_smem(float (&acc)[8][4], bf16* xs, bf16* ws,
                                                 const bf16* x, const bf16* w1, int rows,
                                                 int d_in, int d_h, int r0, int u0, int ks0,
                                                 int ks1, int warp, int lane, int tid) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int kb = ks0; kb < ks1; kb += KB) {
    const int k0 = 16 * kb;
    __syncthreads();   // the last batch's fragments are read
    for (int i = tid; i < (128 + 64) * 8; i += NT) {
      const int r = i / 8, c = i % 8, gk = k0 + 8 * c;
      const bool xr = r < 128;
      const int gr = xr ? r0 + r : u0 + r - 128;
      const bool ok = gr < (xr ? rows : d_h) && gk < d_in;
      cp_async16(smem_u32((xr ? xs + r * SLD : ws + (r - 128) * SLD) + 8 * c),
                 (xr ? x : w1) + (ok ? (size_t)gr * d_in + gk : 0), ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      if (kb + s >= ks1) break;
      const bf16* xr = xs + (16 * warp + g) * SLD + 16 * s + 2 * t;
      const uint32_t a[4] = {lds32(xr), lds32(xr + 8 * SLD), lds32(xr + 8),
                             lds32(xr + 8 * SLD + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* wr = ws + (8 * nt + g) * SLD + 16 * s + 2 * t;
        mma_bf16(acc[nt], a, lds32(wr), lds32(wr + 8));
      }
    }
  }
}

// layer 2 over the chunk at columns col0 .. col0 + nu - 1 (nu <= CH) of
// row r of the hidden tile (row stride ld): the fixed fmaf chain against
// w2's columns, taken from w2s (fp32 copies, [j][ld]) when staged, else
// from w2
__device__ __forceinline__ float chunk_sum(const float* as, const float* w2s, int ld, int r,
                                           int col0, int nu, const bf16* w2, int j, int d_h,
                                           int u0) {
  float c = 0.f;
#pragma unroll
  for (int u = 0; u < CH; ++u)
    if (u < nu)
      c = fmaf(as[r * ld + col0 + u],
               w2s ? w2s[j * ld + col0 + u]
                   : __bfloat162float(w2[(size_t)j * d_h + u0 + col0 + u]),
               c);
  return c;
}

// the ticket: an acq_rel add at gpu scope, so the block's partials
// (ordered before it by the barrier) are visible to the block that sees
// the last ticket, and that block sees every other block's
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

constexpr int PF = 4;          // w2 values a thread prefetches
constexpr int PA = 4;          // chunk or group sums a thread of the last block loads at once
constexpr int GS = 4096;       // group sums the BIG = false last block holds

template <bool BIG>
__global__ void __launch_bounds__(NT, BIG ? 2 : 1)
    mlp_fwd_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                       const bf16* __restrict__ b2, bf16* __restrict__ out, float* partial,
                       int* counters, int rows, int d_in, int d_h, int d_out) {
  using M = Mma<BIG>;
  constexpr int U = M::UNITS, AL = U + 1;   // rows padded: no bank conflicts
  __shared__ float red[BIG ? 1 : KS][16][CH];   // the slices' sums (BIG = false)
  // relu(h) rounded to bf16; in the BIG kernel first the staged x and w1
  __shared__ __align__(16) float tile[M::ROWS * AL];
  float (*as)[AL] = reinterpret_cast<float (*)[AL]>(tile);
  __shared__ float w2s[NT * PF / U * AL];       // w2's columns of this block's units
  __shared__ float b1s[U], b2s[NT];
  __shared__ float gbuf[BIG ? 1 : GS];          // the last block's group sums
  __shared__ int is_last;

  const int rb = blockIdx.x, blk = blockIdx.y;
  const int r0 = rb * M::ROWS, u0 = blk * U;
  const int nr = min(M::ROWS, rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nks = (d_in + 15) / 16, sl = (nks + KS - 1) / KS;
  const int n_chunks = (d_h + CH - 1) / CH, n_groups = (n_chunks + GRP - 1) / GRP;

  // w2's values of this block's units, b1's and b2's, loaded now and
  // stored to shared memory after the products, so their latency hides
  // behind them
  const bool stage_w2 = d_out * U <= NT * PF;
  float w2r[PF], b1r = 0.f, b2r = 0.f;
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    const int i = tid + NT * p, j = i / U, u = i % U;
    w2r[p] = stage_w2 && j < d_out && u0 + u < d_h ? __bfloat162float(w2[(size_t)j * d_h + u0 + u])
                                                   : 0.f;
  }
  if (tid < U && u0 + tid < d_h) b1r = __bfloat162float(b1[u0 + tid]);
  if (tid < d_out) b2r = __bfloat162float(b2[tid]);

  float tot[BIG ? U / 8 : 1][4];
  if constexpr (!BIG) {
    // warp = slice: its chain over 16 rows x 8 units
    slice_chain(tot[0], x, w1, rows, d_in, d_h, r0, u0, min(warp * sl, nks),
                min((warp + 1) * sl, nks), lane);
    red[warp][g][2 * t] = tot[0][0];
    red[warp][g][2 * t + 1] = tot[0][1];
    red[warp][g + 8][2 * t] = tot[0][2];
    red[warp][g + 8][2 * t + 1] = tot[0][3];
  } else {
    // warp = 16 rows: the slices one after another, summed in order
    static_assert(U == 64 && M::ROWS * AL * 4 >= (128 + 64) * SLD * 2, "staging");
    bf16* xs = reinterpret_cast<bf16*>(tile);
    float acc[U / 8][4];
    for (int s = 0; s < KS; ++s) {
      slice_chain_smem(acc, xs, xs + 128 * SLD, x, w1, rows, d_in, d_h, r0, u0,
                       min(s * sl, nks), min((s + 1) * sl, nks), warp, lane, tid);
#pragma unroll
      for (int nt = 0; nt < U / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[nt][e] = s ? tot[nt][e] + acc[nt][e] : acc[nt][e];
    }
  }
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    const int i = tid + NT * p;
    w2s[i / U * AL + i % U] = w2r[p];
  }
  if (tid < U) b1s[tid] = b1r;
  b2s[tid] = b2r;
  __syncthreads();

  // h + b1, relu, rounded to bf16 (0 past d_h)
  if constexpr (!BIG) {
    if (tid < 16 * CH) {
      const int r = tid / CH, u = tid % CH;
      float h = red[0][r][u];
#pragma unroll
      for (int s = 1; s < KS; ++s) h += red[s][r][u];
      as[r][u] = u0 + u < d_h ? __bfloat162float(__float2bfloat16_rn(fmaxf(h + b1s[u], 0.f)))
                              : 0.f;
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < U / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e >> 1), u = 8 * nt + 2 * t + (e & 1);
        as[r][u] = u0 + u < d_h
                       ? __bfloat162float(__float2bfloat16_rn(fmaxf(tot[nt][e] + b1s[u], 0.f)))
                       : 0.f;
      }
  }
  __syncthreads();

  // this block's layer-2 partials: a chunk sum (BIG = false) or a group
  // sum of chunk sums in order (BIG = true)
  const float* w2p = stage_w2 ? w2s : nullptr;
  for (int i = tid; i < nr * d_out; i += NT) {
    const int r = i / d_out, j = i % d_out;
    float p = 0.f;
    const int nc = BIG ? min(GRP, n_chunks - GRP * blk) : 1;
    for (int c = 0; c < nc; ++c)
      p += chunk_sum(&as[0][0], w2p, AL, r, CH * c, min(CH, d_h - u0 - CH * c), w2, j, d_h, u0);
    partial[((size_t)blk * rows + r0 + r) * d_out + j] = p;
  }
  __syncthreads();
  if (tid == 0) is_last = ticket_add(&counters[rb]) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;

  // the last block.  Group sums into shared memory, [group][output] (the
  // BIG kernel reuses the hidden tile): thread i takes output i % n_out,
  // so a warp reads consecutive partials; PA a thread at a time, every
  // load issued before any sum.  A group sum is the chunk sums in order
  // (BIG = false) or what its BIG block wrote.
  const int n_out = nr * d_out;
  float* gs = BIG ? &as[0][0] : gbuf;
  const bool staged = n_out * n_groups <= (BIG ? M::ROWS * U : GS);
  constexpr int NV = BIG ? 1 : GRP;   // partials a group sum reads
  for (int i0 = tid; staged && i0 < n_out * n_groups; i0 += NT * PA) {
    float v[PA][NV];
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int i = i0 + NT * p, o = i % n_out, gi = i / n_out;
      const int nc = BIG ? 1 : min(GRP, n_chunks - GRP * gi);
#pragma unroll
      for (int c = 0; c < NV; ++c)
        v[p][c] = gi < n_groups && c < nc
                      ? __ldcg(&partial[((size_t)(NV * gi + c) * rows + r0) * d_out + o])
                      : 0.f;
    }
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int i = i0 + NT * p, gi = i / n_out;
      if (gi >= n_groups) continue;
      const int nc = BIG ? 1 : min(GRP, n_chunks - GRP * gi);
      float gsum = BIG ? v[p][0] : 0.f;
      if constexpr (!BIG) {
#pragma unroll
        for (int c = 0; c < NV; ++c)
          if (c < nc) gsum += v[p][c];
      }
      gs[i] = gsum;
    }
  }
  __syncthreads();

  // one thread an output: the group sums in order, b2, one rounding
  for (int o = tid; o < n_out; o += NT) {
    float sum = 0.f;
    if (staged) {
#pragma unroll 8
      for (int gi = 0; gi < n_groups; ++gi) sum += gs[gi * n_out + o];
    } else {
      for (int gi = 0; gi < n_groups; ++gi) {
        float gsum = 0.f;
        if constexpr (BIG) {
          gsum = __ldcg(&partial[((size_t)gi * rows + r0) * d_out + o]);
        } else {
          const int nc = min(GRP, n_chunks - GRP * gi);
          for (int c = 0; c < nc; ++c)
            gsum += __ldcg(&partial[((size_t)(GRP * gi + c) * rows + r0) * d_out + o]);
        }
        sum += gsum;
      }
    }
    const int j = o % d_out;
    out[(size_t)r0 * d_out + o] =
        __float2bfloat16_rn(sum + (j < NT ? b2s[j] : __bfloat162float(b2[j])));
  }
  if (tid == 0) counters[rb] = 0;
}

// ---------------------------------------------------------------------------
// fp32: the FMA kernel

constexpr int R = 8;       // rows per block
constexpr int UNITS = 32;  // hidden units per block
constexpr int UPW = UNITS / (NT / 32);  // units per warp

__global__ void __launch_bounds__(NT)
    mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, float* partial,
                   int* counters, int rows, int d_in, int d_h, int d_out) {
  constexpr int VEC = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [R][d_in]
  float* as = xs + (size_t)R * d_in;           // [R][UNITS] hidden chunk
  __shared__ int is_last;

  const int rb = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int r0 = rb * R, u0 = split * UNITS;
  const int nr = min(R, rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid * VEC; i < R * d_in; i += NT * VEC) {
    const int r = i / d_in, c = i % d_in;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nr) val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * d_in + c);
    *reinterpret_cast<uint4*>(xs + (size_t)r * d_in + c) = val;
  }
  __syncthreads();

  for (int uu = 0; uu < UPW; ++uu) {
    const int ul = warp * UPW + uu, u = u0 + ul;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (u < d_h) {
      const float* wrow = w1 + (size_t)u * d_in;
      for (int c = lane * VEC; c < d_in; c += 32 * VEC) {
        const float4 wv = *reinterpret_cast<const float4*>(wrow + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + (size_t)r * d_in + c);
          acc[r] = fmaf(xv.x, wv.x, acc[r]);
          acc[r] = fmaf(xv.y, wv.y, acc[r]);
          acc[r] = fmaf(xv.z, wv.z, acc[r]);
          acc[r] = fmaf(xv.w, wv.w, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float h = u < d_h ? acc[r] + b1[u] : 0.f;
        as[r * UNITS + ul] = fmaxf(h, 0.f);
      }
    }
  }
  __syncthreads();

  const int nu = min(UNITS, d_h - u0);
  for (int i = tid; i < nr * d_out; i += NT) {
    const int r = i / d_out, j = i % d_out;
    const float* w2row = w2 + (size_t)j * d_h + u0;
    float s = 0.f;
    for (int t = 0; t < nu; ++t) s = fmaf(as[r * UNITS + t], w2row[t], s);
    partial[((size_t)split * rows + r0 + r) * d_out + j] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[rb], 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < nr * d_out; i += NT) {
    const int r = i / d_out, j = i % d_out;
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp)
      s += __ldcg(&partial[((size_t)sp * rows + r0 + r) * d_out + j]);
    out[(size_t)(r0 + r) * d_out + j] = s + b2[j];
  }
  if (tid == 0) counters[rb] = 0;
}

// the device time of a launch that does nothing: the floor any kernel
// of this card pays
__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" {

// Scratch a call needs: fp32 partials (floats) and zeroed tickets (ints,
// one a row block; every call leaves them zero again).
long long fdt_mlp_partial_floats(int dtype, int rows, int d_h, int d_out) {
  const long long n_chunks = (d_h + CH - 1) / CH;
  const long long blocks = dtype == 1 ? (rows <= SMALL_ROWS ? n_chunks : (n_chunks + GRP - 1) / GRP)
                                      : (d_h + UNITS - 1) / UNITS;
  return blocks * rows * d_out;
}

int fdt_mlp_counters(int dtype, int rows) {
  const int per = dtype == 1 ? (rows <= SMALL_ROWS ? Mma<false>::ROWS : Mma<true>::ROWS) : R;
  return (rows + per - 1) / per;
}

// dtype: 0 = float32, 1 = bfloat16.  x [rows, d_in], w1 [d_h, d_in],
// b1 [d_h], w2 [d_out, d_h], b2 [d_out], out [rows, d_out]; all
// contiguous, d_in a multiple of 16 bytes' worth of elements; partial and
// counters sized by the two functions above, counters zero.
int fdt_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, void* partial, void* counters, int dtype,
                      int rows, int d_in, int d_h, int d_out, void* stream) {
  if (rows <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int* c = static_cast<int*>(counters);
  if (dtype == 1) {
    const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1),
               *b1b = static_cast<const bf16*>(b1), *w2b = static_cast<const bf16*>(w2),
               *b2b = static_cast<const bf16*>(b2);
    bf16* ob = static_cast<bf16*>(out);
    const int n_chunks = (d_h + CH - 1) / CH;
    const dim3 grid = rows <= SMALL_ROWS
                          ? dim3((rows + 15) / 16, n_chunks)
                          : dim3((rows + 127) / 128, (n_chunks + GRP - 1) / GRP);
    if (rows <= SMALL_ROWS)
      mlp_fwd_kernel_mma<false><<<grid, NT, 0, s>>>(xb, w1b, b1b, w2b, b2b, ob, p, c, rows,
                                                    d_in, d_h, d_out);
    else
      mlp_fwd_kernel_mma<true><<<grid, NT, 0, s>>>(xb, w1b, b1b, w2b, b2b, ob, p, c, rows, d_in,
                                                   d_h, d_out);
    return (int)cudaGetLastError();
  }
  const size_t bytes = ((size_t)R * d_in + (size_t)R * UNITS) * sizeof(float);
  if (bytes > 48 * 1024) {
    static int smem_set[FDT_MAX_DEVICES];
    cudaError_t err = smem_attr_once(mlp_fwd_kernel, (int)bytes, smem_set);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((rows + R - 1) / R, (d_h + UNITS - 1) / UNITS);
  mlp_fwd_kernel<<<grid, NT, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), p, c, rows, d_in, d_h, d_out);
  return (int)cudaGetLastError();
}

// One empty kernel on the stream (the launch floor beside the MLP's time).
int fdt_launch_floor(void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_floor_kernel<<<1, 32, 0, s>>>();
  return (int)cudaGetLastError();
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
