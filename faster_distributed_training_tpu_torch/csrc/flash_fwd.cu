// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernels faster_distributed_training_tpu/ops/
// flash_attention.py::_flash_fwd_pallas (kernel body :183) and, at long
// context, _flash_fwd_kblocked (kernel body :315): one function, which
// the TPU splits in two only to fit VMEM (whole K/V resident, or a
// k-block grid axis with running m/l/acc scratch).  This kernel streams
// K/V, so it serves both.  Same function: s = q.k^T / sqrt(D) + key bias
// (fp32), fp32 row softmax, hash dropout on p in the p.v product only (the
// normaliser l sums the undropped p), out = (p.v) / max(l, 1e-30),
// optional row lse.  The lse comes as a head (lse = m + log l, rounded to
// fp32) and, optionally, its low-order tail (lse_lo = (m - lse) + log l):
// at a fully masked row m is near -1e9, where fp32 steps by 64 and log l
// vanishes from the head, so the backward's p = exp((s - lse) - lse_lo)
// keeps the row normalized (the dense VJP's mean-of-V gradient).
//
// What bounds it on this card: two L x L x D products against O(L D)
// bytes.  At path E's shape (B 4, H 8, L 8192, D 64) the products take
// 0.56 ms at 989 TFLOP/s against ~0.03 ms of traffic; at the serving
// shape (B 8, H 8, L 512) the two bounds meet near the bf16 ridge.  Beside
// the products every score needs ~10 fp32 operations (scale and bias, max,
// exp, sum, bf16 pack) and, under dropout, ~10 integer ones (the hash),
// so the kernel keeps every score on the registers of the thread that owns
// it and feeds the tensor cores from there.
//
// Design, bf16 (the training and serving dtype): flash_fwd_kernel_sm90<D>,
// the backward's dq_kernel_sm90 skeleton (csrc/flash_bwd.cu) with an online
// softmax in place of dS.  One block per (b*h, 128 q rows), two warpgroups
// of 64 rows (wgmma M = 64).  Q is loaded once into the swizzled tile that
// the wgmma descriptors name (csrc/sm90.cuh); K, V and the key bias stream
// through a two-stage cp.async ring of 64-key tiles, the next tile's
// 16-byte copies issued before this tile's products.  S = Q.K^T is wgmma
// SS into fp32 fragments: each thread owns rows r and r + 8 of its warp's
// 16 and pairs of key columns.  Scale and bias, the row max (two shuffles
// across the quad that shares a row), the online-softmax correction of O,
// exp, the partial row sum and the dropout keep test all run on those
// fragments; P is packed to bf16 in registers and feeds O += P.V as the A
// operand of wgmma RS, B = the V tile read MN-major through the transpose
// bit.  O stays fp32 in registers for the whole key loop; no score- or
// probability-shaped tile reaches shared or device memory.  The epilogue
// divides by l, packs to bf16 and stores into the strided [B, L, H, D]
// context buffer.  Edges: rows and keys past Lq / Lk load as zeros (cp.async
// with source size 0); keys past Lk carry bias -inf, so a zero key never
// scores 0 into the max.  The per-tile work outside the products is kept
// short: the (b, h) operand pointers are computed once, the tile loads have
// compile-time trip counts, and the dropout test is taken once a tile, not
// once a score (on the card this cut the time a call by a third at path
// E's shape: PERF.md).  Occupancy: at D <= 64 a thread fits 128 registers
// and two blocks share an SM; at D 128 (O is 64 fp32 a thread) one block
// runs.
// Against the WMMA kernel this replaces: shared memory holds bf16 operand
// tiles only (fp32 scores and accumulators went through it before), loads
// are 16-byte and asynchronous instead of 2-byte and synchronous, the
// products are wgmma over 64-row tiles instead of WMMA 16x16x16, and the
// softmax spreads over all 256 threads' fragments instead of two threads
// a row.
//
// fp32 (correctness checks only) keeps the FMA kernel flash_fwd_kernel<D>:
// 64-row q tiles, four warps of 16 rows, fp32 score tiles and accumulator
// in shared memory, products on the FMA units at full precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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
  const uint32_t* seed;  // the dropout seed on the device (read when dropout)
  uint32_t b0, h0;
  int h_glob;
  uint32_t thresh;
  float keep_scale;
};

// fmix(seed ^ bh) with the GLOBAL bh = (b0 + n / H) * h_glob + h0 + n % H
// of flattened instance n: the dropout stream is fmix(fmix(head ^ q row)
// ^ key), as ops/attention.py::dropout_keep
__device__ __forceinline__ uint32_t head_hash(const Args& a, int n) {
  const uint32_t bh = (a.b0 + (uint32_t)(n / a.H)) * (uint32_t)a.h_glob + a.h0 +
                      (uint32_t)(n % a.H);
  return fmix32(__ldg(a.seed) ^ bh);
}

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel

using bf16 = __nv_bfloat16;
constexpr int NTW = 256;  // two warpgroups

template <int D>
struct Cfg {
  static constexpr int BQ = 128;  // q rows per block
  static constexpr int BK = 64;   // keys a ring stage
  using QB = SwTile<D, BQ>;
  using KT = SwTile<D, BK>;
  // Q | 2 x (K, V) | 2 x key bias ; +1 KB to align
  static constexpr int bytes = QB::BYTES + 4 * KT::BYTES + 2 * BK * 4 + 1024;
};

// rows r0 .. r0+R-1 of a (b, h) slice into a swizzled tile; rows past n
// are zero-filled (nothing is read for them)
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src, long long sl, int r0,
                                          int n, int tid) {
  constexpr int CH = D / 8, N = (R * CH + NTW - 1) / NTW;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = tid + j * NTW, r = i / CH, c = i % CH, g = r0 + r;
    if ((R * CH) % NTW && i >= R * CH) break;
    const bf16* p = src + (long long)(g < n ? g : 0) * sl + 8 * c;
    cp_async16(tile + SwTile<D, R>::offset(r, c), p, g < n ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NTW, D <= 64 ? 2 : 1) flash_fwd_kernel_sm90(const Args a) {
  using C = Cfg<D>;
  using QB = typename C::QB;
  using KT = typename C::KT;
  constexpr int BK = C::BK, NA = D / 2, NS = BK / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + QB::BYTES;        // 2 stages
  const uint32_t sV = sK + 2 * KT::BYTES;    // 2 stages
  float* bias_s = reinterpret_cast<float*>(smem_raw + (sV + 2 * KT::BYTES - raw));

  const int n = blockIdx.x, q0 = blockIdx.y * C::BQ;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;

  // this (b, h)'s K, V and key-bias rows, computed once
  const int b = n / a.H, h = n % a.H;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk_b + h * a.sk_h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv_b + h * a.sv_h;
  const float* bias_row = a.bias ? a.bias + (long long)b * a.Lk : nullptr;

  // key tile t into ring stage s: K, V and the key bias (-inf past Lk)
  auto load_stage = [&](int t, int s) {
    const int k0 = t * BK;
    load_tile<D, BK>(sK + s * KT::BYTES, kp, a.sk_l, k0, a.Lk, tid);
    load_tile<D, BK>(sV + s * KT::BYTES, vp, a.sv_l, k0, a.Lk, tid);
    if (tid < BK) {
      const int kc = k0 + tid;
      float* dst = bias_s + s * BK + tid;
      if (kc >= a.Lk)
        *dst = neg_inf();   // keys past Lk: p = 0, and out of the max
      else if (bias_row)
        cp_async4(smem_u32(dst), bias_row + kc, 4);
      else
        *dst = 0.f;
    }
  };

  load_tile<D, C::BQ>(sQ, static_cast<const bf16*>(a.q) + b * a.sq_b + h * a.sq_h, a.sq_l, q0,
                      a.Lq, tid);
  load_stage(0, 0);
  cp_async_commit();

  // this thread's two q rows (accumulator rows 16w + l/4 and + 8 of its
  // warpgroup's 64): running max, its share of the row sum (the quad's
  // four shares add up in the epilogue; every correction scales them
  // alike), and the row's dropout hash
  const int row0 = q0 + 64 * wg + 16 * w + (l >> 2);
  const uint32_t hhead = a.dropout ? head_hash(a, n) : 0u;
  float m_r[2], l_r[2];
  uint32_t hq_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_r[i] = neg_inf();
    l_r[i] = 0.f;
    hq_r[i] = fmix32(hhead ^ (uint32_t)(row0 + 8 * i));
  }

  float O[NA], S[NS];
#pragma unroll
  for (int i = 0; i < NA; ++i) O[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) S[i] = 0.f;

  const int nk = (a.Lk + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    cp_async_wait<0>();   // tile t (and, at t = 0, Q) landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; stage s ^ 1 is free
    if (t + 1 < nk) load_stage(t + 1, s ^ 1);
    cp_async_commit();
    const uint32_t k_s = sK + s * KT::BYTES, v_s = sV + s * KT::BYTES;

    // S = Q.K^T (this warpgroup's 64 q rows x BK keys)
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK>::ss(S, QB::kmajor(sQ, 64 * wg, kk), KT::kmajor(k_s, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);

    // s = S * scale + bias, and the tile's row max
    const float* bs = bias_s + s * BK;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 bias2 = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * (l & 3));
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          S[x] = S[x] * a.scale + (c ? bias2.y : bias2.x);
          mx[i] = fmaxf(mx[i], S[x]);
        }
    }
    // the quad (lanes 4g .. 4g+3) shares each row; every tile holds a key
    // below Lk with a finite bias, so the new max is finite
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = __expf(m_r[i] - mx[i]);   // 0 at the first tile (m = -inf)
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        O[4 * j + 2 * i] *= corr[i];
        O[4 * j + 2 * i + 1] *= corr[i];
      }

    // e = exp(s - m); l sums the undropped e; p = e * keep (the test
    // taken once a tile, so each loop runs straight)
    if (a.dropout) {
      const uint32_t k0 = t * BK + 2 * (l & 3);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i + c;
            const float e = __expf(S[x] - m_r[i]);
            l_r[i] += e;
            const uint32_t key = k0 + 8 * j + c;
            S[x] = e * (fmix32(hq_r[i] ^ key) < a.thresh ? a.keep_scale : 0.f);
          }
    } else {
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int i = (x >> 1) & 1;
        S[x] = __expf(S[x] - m_r[i]);
        l_r[i] += S[x];
      }
    }
    // the m64k16 A fragment of k step kk is accumulator columns 16kk..+15
    uint32_t fp[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) fp[kk][r] = pack_bf16(S[8 * kk + 2 * r], S[8 * kk + 2 * r + 1]);

    // O += P.V (B = the V tile read MN-major)
    fence_regs(O);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::rs(O, fp[kk], KT::mnmajor(v_s, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(O);
  }

  bf16* out = static_cast<bf16*>(a.out) + (n / a.H) * a.so_b + (n % a.H) * a.so_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lsum = l_r[i] + __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int qr = row0 + 8 * i;
    if (qr >= a.Lq) continue;
    const float l_c = fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (l & 3), x = 4 * j + 2 * i;
      *reinterpret_cast<uint32_t*>(out + qr * a.so_l + col) =
          pack_bf16(O[x] / l_c, O[x + 1] / l_c);
    }
    if (a.lse && (l & 3) == 0) {
      const float log_l = logf(l_c);
      const float head = m_r[i] + log_l;
      a.lse[(long long)n * a.Lq + qr] = head;
      if (a.lse_lo) a.lse_lo[(long long)n * a.Lq + qr] = (m_r[i] - head) + log_l;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Args& a, int N, cudaStream_t stream) {
  using C = Cfg<D>;
  static int smem_set[FDT_MAX_DEVICES];
  cudaError_t err = smem_attr_once(flash_fwd_kernel_sm90<D>, C::bytes, smem_set);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel_sm90<D><<<dim3(N, (a.Lq + C::BQ - 1) / C::BQ), NTW, C::bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the FMA kernel

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads: 4 warps x 16 q rows

template <int D>
struct Tile {
  // rows get one pad element (conflict-free column walks)
  static constexpr int QS = D + 1;   // Q/K/V row stride
  static constexpr int PS = BK + 1;  // P row stride
  static constexpr int SS = BK + 4;  // score row stride
  static constexpr int OS = D + 4;   // accumulator stride
  static constexpr size_t bytes =
      (size_t)(BQ * QS + 2 * BK * QS + BQ * PS + BQ * SS + BQ * OS + BK) * sizeof(float);
};

// S[16 rows of this warp][BK] = Q K^T
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks, float* Ss, int warp,
                                       int lane) {
  using L = Tile<D>;
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
}

// O[16 rows of this warp][D] += P V
template <int D>
__device__ __forceinline__ void accumulate_pv(const float* Ps, const float* Vs, float* Os,
                                              int warp, int lane) {
  using L = Tile<D>;
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
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Args a) {
  using L = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * L::QS;
  float* Vs = Ks + BK * L::QS;
  float* Ps = Vs + BK * L::QS;
  float* Ss = Ps + BQ * L::PS;
  float* Os = Ss + BQ * L::SS;
  float* bias_s = Os + BQ * L::OS;

  const int n = blockIdx.x;  // flattened b*H + h
  const int q0 = blockIdx.y * BQ;
  const int b = n / a.H, h = n % a.H;
  const float* q = static_cast<const float*>(a.q) + b * a.sq_b + h * a.sq_h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk_b + h * a.sk_h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv_b + h * a.sv_h;
  float* out = static_cast<float*>(a.out) + b * a.so_b + h * a.so_h;
  const float* bias_row = a.bias ? a.bias + (long long)b * a.Lk : nullptr;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qr = q0 + r;
    Qs[r * L::QS + d] = qr < a.Lq ? q[qr * a.sq_l + d] : 0.f;
  }
  for (int i = tid; i < BQ * L::OS; i += NT) Os[i] = 0.f;

  // softmax ownership: thread pair (row, half) keeps row's m and l; the
  // rows of warp w are 16w..16w+15, the same rows its products touch
  const int row = tid >> 1, half = tid & 1;
  float m_i = neg_inf(), l_i = 0.f;
  const uint32_t hq = a.dropout ? fmix32(head_hash(a, n) ^ (uint32_t)(q0 + row)) : 0u;

  for (int k0 = 0; k0 < a.Lk; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D, kc = k0 + c;
      const bool ok = kc < a.Lk;
      Ks[c * L::QS + d] = ok ? k[kc * a.sk_l + d] : 0.f;
      Vs[c * L::QS + d] = ok ? v[kc * a.sv_l + d] : 0.f;
    }
    if (tid < BK) {
      const int kc = k0 + tid;
      bias_s[tid] = kc < a.Lk ? (bias_row ? bias_row[kc] : 0.f) : neg_inf();
    }
    __syncthreads();

    scores<D>(Qs, Ks, Ss, warp, lane);
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
    float* prow = Ps + row * L::PS + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float e = expf(sv[j] - m_new);
      ls += e;
      float p = e;
      if (a.dropout) {
        const uint32_t hk = fmix32(hq ^ (uint32_t)(k0 + half * 32 + j));
        p = e * (hk < a.thresh ? a.keep_scale : 0.f);
      }
      prow[j] = p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l_i = l_i * corr + ls;
    m_i = m_new;
    float* orow = Os + row * L::OS + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) orow[d] *= corr;
    __syncwarp();

    accumulate_pv<D>(Ps, Vs, Os, warp, lane);
    __syncwarp();
  }

  const float l_c = fmaxf(l_i, 1e-30f);
  const int qr = q0 + row;
  if (qr < a.Lq) {
    const float* orow = Os + row * L::OS + half * (D / 2);
    float* dst = out + qr * a.so_l + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) dst[d] = orow[d] / l_c;
    if (a.lse && half == 0) {
      const float log_l = logf(l_c);
      const float head = m_i + log_l;
      a.lse[(long long)n * a.Lq + qr] = head;
      if (a.lse_lo) a.lse_lo[(long long)n * a.Lq + qr] = (m_i - head) + log_l;
    }
  }
}

template <int D>
cudaError_t launch_f32(const Args& a, int N, cudaStream_t stream) {
  using L = Tile<D>;
  static int smem_set[FDT_MAX_DEVICES];
  cudaError_t err = smem_attr_once(flash_fwd_kernel<D>, (int)L::bytes, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(N, (a.Lq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NT, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Dynamic shared memory of the bf16 kernel at head dim D, or 0 for a head
// dim it does not take.
int fdt_flash_fwd_smem_bytes(int D) {
  switch (D) {
    case 16: return Cfg<16>::bytes;
    case 32: return Cfg<32>::bytes;
    case 64: return Cfg<64>::bytes;
    case 128: return Cfg<128>::bytes;
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  D must be 16, 32, 64 or 128.
// seed: the dropout seed, a u32 on the device (the low word of an int64
// is one), read by the kernel, so a captured graph replays with whatever
// value it holds then; null without dropout.
// Strides are in elements.  bf16 tensors must have 16-byte-aligned bases
// and (b, h, l) strides that are multiples of 8 (16-byte rows).
int fdt_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                  void* lse, void* lse_lo, int dtype, int B, int H, int Lq, int Lk, int D,
                  long long sq_b, long long sq_h, long long sq_l, long long sk_b,
                  long long sk_h, long long sk_l, long long sv_b, long long sv_h,
                  long long sv_l, long long so_b, long long so_h, long long so_l,
                  float scale, int dropout, const void* seed, unsigned int b0,
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
  a.seed = static_cast<const uint32_t*>(seed);
  a.b0 = b0;
  a.h0 = h0;
  a.h_glob = h_glob;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const long long strides[] = {sq_b, sq_h, sq_l, sk_b, sk_h, sk_l,
                                 sv_b, sv_h, sv_l, so_b, so_h, so_l};
    for (long long st : strides)
      if (st % 8) return (int)cudaErrorMisalignedAddress;
    const void* ptrs[] = {q, k, v, out};
    for (const void* p : ptrs)
      if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
    switch (D) {
      case 16: return (int)launch_bf16<16>(a, B * H, s);
      case 32: return (int)launch_bf16<32>(a, B * H, s);
      case 64: return (int)launch_bf16<64>(a, B * H, s);
      case 128: return (int)launch_bf16<128>(a, B * H, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return (int)launch_f32<16>(a, B * H, s);
    case 32: return (int)launch_f32<32>(a, B * H, s);
    case 64: return (int)launch_f32<64>(a, B * H, s);
    case 128: return (int)launch_f32<128>(a, B * H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
