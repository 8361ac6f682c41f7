// Flash-attention backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3).
//
// Replaces: ray_tpu/ops/flash_attention.py:_bwd_dq_kernel (K2) and
// :_bwd_dkv_kernel (K3), the Pallas kernels that _flash_bwd launches.
// Both recompute the probabilities from the forward's log-sum-exp instead
// of reading a stored [sq, skv] matrix:
//   S = scale * Q K^T (masked), P = exp(S - lse), dP = dO V^T,
//   dS = P * (dP - delta) * scale, with delta = rowsum(dO * O) given,
//   dQ = dS K (K2); dV = P^T dO and dK = dS^T Q (K3).
// As on the TPU, P is rounded to dO's type before dV and dS to K's (Q's)
// type before dQ (dK); every product accumulates in float32. A row whose
// lse is -inf (no visible key) gets a zero gradient. The causal mask keeps
// k_pos <= q_pos, aligned at the top left, as the forward does.
//
// What bounds them on an H100: at the Llama-3-8B training shape (b 2,
// h 32, hk 8, d 128, s 2048, causal) K2 does three products over the
// causal pairs (103 GFLOP) and K3 four (137 GFLOP) against about 118 MB
// and 100 MB of compulsory traffic: about 1,000 FLOP per byte, far above
// the card's ridge of about 295 in bf16. The tensor cores bound both.
//
// What the design does about that (bf16): every product runs on the
// tensor cores as mma.sync m16n8k16 (bf16 in, float32 accumulate) fed by
// ldmatrix from shared memory, and the score tiles never leave registers:
// the fragments of S and dP are turned into P and dS in place and repacked
// as the left operand of the next product. Tiles stream through a
// two-stage cp.async ring. No block writes another's output, so there are
// no atomics and the result does not depend on the schedule.
// - K2: a block owns 64 q rows of one head (16 a warp) and walks the kv
//   tiles up to the causal limit, reading kv head h / n_rep through
//   strides. Its dQ accumulator stays in registers and is written once.
// - K3: a block owns 64 kv rows of one kv head (16 a warp) and walks the
//   n_rep q heads of its group and, in each, the q tiles from the causal
//   start, so dK and dV are summed over the whole GQA group in registers
//   (the TPU kernel's in-kernel group sum) and written once. It computes
//   the transposed scores K Q^T, so the warp's rows are kv rows and P^T and
//   dS^T are left operands of dV and dK as they stand. Two float32
//   accumulators of width d do not fit in registers at d 256, so there the
//   block makes two passes, each accumulating half of the columns and
//   recomputing P and dS.
// The causal tiles are scheduled heaviest first. Not yet used: wgmma, TMA
// and warp specialisation.
//
// The float32 path is scalar FMA over shared-memory tiles; it exists so
// the kernels can be held to float32 exactness.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  int h, n_rep, sq, skv, causal;
  float scale;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long a_sb, a_ss, a_sh;   // dq (K2) or dk (K3)
  long long b_sb, b_ss, b_sh;   // dv (K3)
};

// lse in base-2 units; a fully masked row (lse -inf) becomes +inf, so that
// exp2(s - lse) is 0 there: a zero gradient instead of exp(nan)
__device__ __forceinline__ float lse_log2(float x) {
  return x == -INFINITY ? INFINITY : x * kLog2e;
}

__device__ __forceinline__ long long row_index(int b, int h, int nh, int s, int row) {
  return ((long long)b * nh + h) * s + row;
}

// Start the asynchronous copy of rows [row0, row0 + ROWS) of a [s, D]
// matrix into shared memory rows of LD elements; rows at or past `nvalid`
// are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, long long row_stride,
                                                int row0, int nvalid) {
  constexpr int per_row = D / 8;
  for (int i = threadIdx.x; i < ROWS * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * 8;
    const bool ok = r < nvalid;
    cp_async_16(dst + r * LD + c, ok ? src + (long long)(row0 + r) * row_stride + c : src, ok);
  }
}

// Two score tiles of the warp's 16 rows against N rows held in shared
// memory: s = A B^T and t = C E^T over the head dim D. A and C are the
// warp's own rows (16 x D at a and c), B and E the N streamed rows.
template <int D, int N, int LD>
__device__ __forceinline__ void two_score_tiles(float (&s)[N / 8][4], float (&t)[N / 8][4],
                                                const bf16* a, const bf16* c, const bf16* bm,
                                                const bf16* em) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t fa[4], fc[4];
    ldmatrix_x4(fa, a + (lane & 15) * LD + k0 + (lane >> 4) * 8);
    ldmatrix_x4(fc, c + (lane & 15) * LD + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      const int off = (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
      uint32_t fb[4], fe[4];
      ldmatrix_x4(fb, bm + off);
      ldmatrix_x4(fe, em + off);
      mma_16816(s[n0 / 8], fa, fb[0], fb[1]);
      mma_16816(s[n0 / 8 + 1], fa, fb[2], fb[3]);
      mma_16816(t[n0 / 8], fc, fe[0], fe[1]);
      mma_16816(t[n0 / 8 + 1], fc, fe[2], fe[3]);
    }
  }
}

// acc (16 x W, columns [c0, c0 + W) of `m`) += x (16 x N, in registers)
// times m (N rows x D in shared memory)
template <int N, int W, int LD>
__device__ __forceinline__ void acc_times_rows(float (&acc)[W / 8][4], const float (&x)[N / 8][4],
                                               const bf16* m, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    uint32_t a[4];
    acc_to_a(a, x[2 * c], x[2 * c + 1]);
#pragma unroll
    for (int n0 = 0; n0 < W; n0 += 16) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, m + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + n0 +
                                (lane >> 4) * 8);
      mma_16816(acc[n0 / 8], a, fb[0], fb[1]);
      mma_16816(acc[n0 / 8 + 1], a, fb[2], fb[3]);
    }
  }
}

// Write a warp's 16 x W float32 accumulator as bf16 rows (rows at or past
// `nrows` are skipped).
template <int W>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int row0, int nrows,
                                           int c0, const float (&acc)[W / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + half * 8 + g;
    if (r >= nrows) continue;
    bf16* out = base + (long long)r * row_stride + c0;
#pragma unroll
    for (int t = 0; t < W / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(out + t * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[t][half * 2], acc[t][half * 2 + 1]);
  }
}

// ---------------------------------------------------------------------------
// K2, bf16: dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int BM = kWarps * 16;         // q rows per block
  static constexpr int BN = D <= 128 ? 64 : 32;  // kv rows per tile
  static constexpr int LD = D + 8;               // 16-byte row pad: conflict-free ldmatrix
  static constexpr int bytes = (2 * BM + 4 * BN) * LD * (int)sizeof(bf16);  // Q, dO, 2 x (K, V)
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, const BwdParams p) {
  using C = DqCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  constexpr int NT = BN / 8;
  constexpr int OT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;      // [2][BN][LD]
  bf16* sV = sK + 2 * BN * LD;   // [2][BN][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int n_qt = (p.sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BM;   // heaviest causal tiles first
  const int w0 = warp * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.n_rep;
  const bf16* kb = k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = v + b * p.v_sb + hk * p.v_sh;

  int n_kt = (p.skv + BN - 1) / BN;
  if (p.causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);

  load_rows_async<BM, D, LD>(sQ, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.sq - q0);
  load_rows_async<BM, D, LD>(sdO, dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.sq - q0);
  if (n_kt > 0) {
    load_rows_async<BN, D, LD>(sK, kb, p.k_ss, 0, p.skv);
    load_rows_async<BN, D, LD>(sV, vb, p.v_ss, 0, p.skv);
  }
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  int row[2];
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + w0 + r * 8 + g;
    const bool ok = row[r] < p.sq;
    const long long i = row_index(b, h, p.h, p.sq, ok ? row[r] : 0);
    l2[r] = ok ? lse_log2(lse[i]) : INFINITY;
    dl[r] = ok ? delta[i] : 0.0f;
  }
  float acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  const float scale2 = p.scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {
      const int kv1 = (kt + 1) * BN;
      load_rows_async<BN, D, LD>(sK + (stage ^ 1) * BN * LD, kb, p.k_ss, kv1, p.skv - kv1);
      load_rows_async<BN, D, LD>(sV + (stage ^ 1) * BN * LD, vb, p.v_ss, kv1, p.skv - kv1);
    }
    cp_async_commit();
    cp_async_wait<1>();   // everything but the tile just started has landed
    __syncthreads();
    const bf16* cK = sK + stage * BN * LD;
    const bf16* cV = sV + stage * BN * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[NT][4], dp[NT][4];
    two_score_tiles<D, BN, LD>(s, dp, sQ + w0 * LD, sdO + w0 * LD, cK, cV);

    // P = exp(S - lse) and dS = P (dP - delta) scale, in place in s
    const int kv0 = kt * BN;
    const bool masked = kv0 + BN > p.skv || (p.causal && kv0 + BN - 1 > q0 + w0);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kv0 + t * 8 + tig * 2 + (e & 1);
        float pr = exp2f(s[t][e] * scale2 - l2[r]);
        if (masked && (col >= p.skv || (p.causal && col > row[r]))) pr = 0.0f;
        s[t][e] = pr * (dp[t][e] - dl[r]) * p.scale;
      }
    }
    // dQ += dS K, with dS rounded to bf16
    acc_times_rows<BN, D, LD>(acc, s, cK, 0);
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  store_rows<D>(dq + b * p.a_sb + h * p.a_sh, p.a_ss, q0 + w0, p.sq, 0, acc);
}

// ---------------------------------------------------------------------------
// K3, bf16: dK and dV, summed over the GQA group
// ---------------------------------------------------------------------------

template <int D>
struct DkvCfg {
  static constexpr int BN = kWarps * 16;          // kv rows per block
  static constexpr int BM = D <= 128 ? 64 : 32;   // q rows per tile
  static constexpr int DH = D <= 128 ? D : 128;   // dK/dV columns per pass
  static constexpr int LD = D + 8;
  static constexpr int tiles = (2 * BN + 4 * BM) * LD * (int)sizeof(bf16);  // K, V, 2 x (Q, dO)
  static constexpr int bytes = tiles + 4 * BM * (int)sizeof(float);          // 2 x (lse, delta)
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, const BwdParams p) {
  using C = DkvCfg<D>;
  constexpr int BN = C::BN, BM = C::BM, DH = C::DH, LD = C::LD;
  constexpr int NT = BM / 8;   // score n-tiles (q columns)
  constexpr int OT = DH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;          // [2][BM][LD]
  bf16* sdO = sQ + 2 * BM * LD;     // [2][BM][LD]
  float* sL = reinterpret_cast<float*>(smem + C::tiles);   // [2][BM], base-2 lse
  float* sD = sL + 2 * BM;                                 // [2][BM], delta

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int kv0 = blockIdx.x * BN;   // under causal, the first kv tiles see the most q tiles
  const int w0 = warp * 16;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_qt = (p.sq + BM - 1) / BM;
  const int qt0 = p.causal ? min(kv0 / BM, n_qt) : 0;   // q tiles ending before kv0 see nothing
  const int per_head = n_qt - qt0;
  const int n_it = p.n_rep * per_head;

  // stage the q tile of step `it` (q head hk * n_rep + it / per_head)
  auto issue = [&](int it, int stage) {
    const int hq = hk * p.n_rep + it / per_head;
    const int qs = (qt0 + it % per_head) * BM;
    load_rows_async<BM, D, LD>(sQ + stage * BM * LD, q + b * p.q_sb + hq * p.q_sh, p.q_ss, qs,
                               p.sq - qs);
    load_rows_async<BM, D, LD>(sdO + stage * BM * LD, dout + b * p.do_sb + hq * p.do_sh, p.do_ss,
                               qs, p.sq - qs);
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      const bool ok = qs + i < p.sq;
      const long long j = row_index(b, hq, p.h, p.sq, ok ? qs + i : 0);
      sL[stage * BM + i] = ok ? lse_log2(lse[j]) : INFINITY;
      sD[stage * BM + i] = ok ? delta[j] : 0.0f;
    }
  };

  load_rows_async<BN, D, LD>(sK, k + b * p.k_sb + hk * p.k_sh, p.k_ss, kv0, p.skv - kv0);
  load_rows_async<BN, D, LD>(sV, v + b * p.v_sb + hk * p.v_sh, p.v_ss, kv0, p.skv - kv0);
  int row[2];   // this thread's kv rows: g and g + 8 of the warp's 16
  row[0] = kv0 + w0 + g;
  row[1] = row[0] + 8;
  const float scale2 = p.scale * kLog2e;

  for (int c0 = 0; c0 < D; c0 += DH) {
    float gk[OT][4], gv[OT][4];
#pragma unroll
    for (int t = 0; t < OT; ++t)
      gk[t][0] = gk[t][1] = gk[t][2] = gk[t][3] = gv[t][0] = gv[t][1] = gv[t][2] = gv[t][3] = 0.0f;
    if (n_it > 0) issue(0, 0);
    cp_async_commit();
    for (int it = 0; it < n_it; ++it) {
      const int stage = it & 1;
      if (it + 1 < n_it) issue(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int qs = (qt0 + it % per_head) * BM;
      const bf16* cQ = sQ + stage * BM * LD;
      const bf16* cdO = sdO + stage * BM * LD;
      const float* cL = sL + stage * BM;
      const float* cD = sD + stage * BM;

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv rows by BM q columns
      float s[NT][4], dp[NT][4];
      two_score_tiles<D, BM, LD>(s, dp, sK + w0 * LD, sV + w0 * LD, cQ, cdO);

      // P^T in s, dS^T in dp
      const bool masked = qs + BM > p.sq || (p.causal && kv0 + w0 + 15 > qs);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = t * 8 + tig * 2 + (e & 1);
          const int col = qs + cl;
          float pr = exp2f(s[t][e] * scale2 - cL[cl]);
          if (masked && (col >= p.sq || (p.causal && row[e >> 1] > col))) pr = 0.0f;
          s[t][e] = pr;
          dp[t][e] = pr * (dp[t][e] - cD[cl]) * p.scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q over columns [c0, c0 + DH), with P
      // and dS rounded to bf16
      acc_times_rows<BM, DH, LD>(gv, s, cdO, c0);
      acc_times_rows<BM, DH, LD>(gk, dp, cQ, c0);
      __syncthreads();
    }
    cp_async_wait<0>();
    store_rows<DH>(dk + b * p.a_sb + hk * p.a_sh, p.a_ss, kv0 + w0, p.skv, c0, gk);
    store_rows<DH>(dv + b * p.b_sb + hk * p.b_sh, p.b_ss, kv0 + w0, p.skv, c0, gv);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA over shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kT = 32;   // rows per tile of the float32 kernels

template <int D>
struct F32Cfg {
  static constexpr int LD = D + 4;      // tile rows (float4 aligned)
  static constexpr int LDS = kT + 1;    // score tiles
  static constexpr int tile = kT * LD;  // floats in one [kT, D] tile
  // K2: Q, dO, K, V tiles, the dQ accumulator, dS, lse, delta
  static constexpr int dq_bytes = (5 * tile + kT * LDS + 2 * kT) * 4;
  // K3: K, V, Q, dO tiles, the dK and dV accumulators, P, dS, lse, delta
  static constexpr int dkv_bytes = (6 * tile + 2 * kT * LDS + 2 * kT) * 4;
};

template <int D>
__device__ void load_tile_f32(float* dst, const float* src, long long row_stride, int row0,
                              int nvalid) {
  constexpr int LD = F32Cfg<D>::LD;
  constexpr int per_row = D / 4;
  for (int i = threadIdx.x; i < kT * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// lse (natural log, fully masked rows as +inf) and delta of rows
// [row0, row0 + kT) into shared memory
__device__ void load_rows_lse(float* sl, float* sd, const float* lse, const float* delta,
                              long long base, int row0, int nrows) {
  for (int i = threadIdx.x; i < kT; i += kThreads) {
    const bool ok = row0 + i < nrows;
    const float x = ok ? lse[base + row0 + i] : INFINITY;
    sl[i] = x == -INFINITY ? INFINITY : x;
    sd[i] = ok ? delta[base + row0 + i] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, const BwdParams p) {
  using S = F32Cfg<D>;
  constexpr int LD = S::LD, LDS = S::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + S::tile;
  float* sK = sdO + S::tile;
  float* sV = sK + S::tile;
  float* sA = sV + S::tile;      // dQ accumulator
  float* sS = sA + S::tile;      // dS
  float* sL = sS + kT * LDS;
  float* sD = sL + kT;

  const int n_qt = (p.sq + kT - 1) / kT;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.n_rep;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh;

  load_tile_f32<D>(sQ, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.sq - q0);
  load_tile_f32<D>(sdO, dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.sq - q0);
  load_rows_lse(sL, sD, lse, delta, row_index(b, h, p.h, p.sq, 0), q0, p.sq);
  for (int i = threadIdx.x; i < S::tile; i += kThreads) sA[i] = 0.0f;

  int n_kt = (p.skv + kT - 1) / kT;
  if (p.causal) n_kt = min(n_kt, (q0 + kT - 1) / kT + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int kv0 = kt * kT;
    __syncthreads();   // every thread is done with the previous K/V tile
    load_tile_f32<D>(sK, kb, p.k_ss, kv0, p.skv - kv0);
    load_tile_f32<D>(sV, vb, p.v_ss, kv0, p.skv - kv0);
    __syncthreads();
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      const bool hide = kv0 + c >= p.skv || (p.causal && kv0 + c > q0 + r);
      const float pr = hide ? 0.0f : expf(dot_rows<D>(sQ + r * LD, sK + c * LD) * p.scale - sL[r]);
      sS[r * LDS + c] = pr * (dot_rows<D>(sdO + r * LD, sV + c * LD) - sD[r]) * p.scale;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kT * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float acc = sA[r * LD + c];
      for (int j = 0; j < kT; ++j) acc = fmaf(sS[r * LDS + j], sK[j * LD + c], acc);
      sA[r * LD + c] = acc;
    }
  }
  __syncthreads();
  float* base = dq + b * p.a_sb + h * p.a_sh;
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < p.sq) base[(long long)(q0 + r) * p.a_ss + c] = sA[r * LD + c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, const BwdParams p) {
  using S = F32Cfg<D>;
  constexpr int LD = S::LD, LDS = S::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + S::tile;
  float* sQ = sV + S::tile;
  float* sdO = sQ + S::tile;
  float* sGK = sdO + S::tile;    // dK accumulator
  float* sGV = sGK + S::tile;    // dV accumulator
  float* sP = sGV + S::tile;     // P^T  [kv][q]
  float* sS = sP + kT * LDS;     // dS^T [kv][q]
  float* sL = sS + kT * LDS;
  float* sD = sL + kT;

  const int kv0 = blockIdx.x * kT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_qt = (p.sq + kT - 1) / kT;
  const int qt0 = p.causal ? min(kv0 / kT, n_qt) : 0;

  load_tile_f32<D>(sK, k + b * p.k_sb + hk * p.k_sh, p.k_ss, kv0, p.skv - kv0);
  load_tile_f32<D>(sV, v + b * p.v_sb + hk * p.v_sh, p.v_ss, kv0, p.skv - kv0);
  for (int i = threadIdx.x; i < S::tile; i += kThreads) sGK[i] = sGV[i] = 0.0f;

  for (int rep = 0; rep < p.n_rep; ++rep) {
    const int hq = hk * p.n_rep + rep;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int qs = qt * kT;
      __syncthreads();   // every thread is done with the previous Q/dO tile
      load_tile_f32<D>(sQ, q + b * p.q_sb + hq * p.q_sh, p.q_ss, qs, p.sq - qs);
      load_tile_f32<D>(sdO, dout + b * p.do_sb + hq * p.do_sh, p.do_ss, qs, p.sq - qs);
      load_rows_lse(sL, sD, lse, delta, row_index(b, hq, p.h, p.sq, 0), qs, p.sq);
      __syncthreads();
      for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
        const int r = i / kT, c = i % kT;   // kv row r, q column c
        const bool hide = qs + c >= p.sq || (p.causal && kv0 + r > qs + c);
        const float pr = hide ? 0.0f : expf(dot_rows<D>(sK + r * LD, sQ + c * LD) * p.scale - sL[c]);
        sP[r * LDS + c] = pr;
        sS[r * LDS + c] = pr * (dot_rows<D>(sV + r * LD, sdO + c * LD) - sD[c]) * p.scale;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kT * D; i += kThreads) {
        const int r = i / D, c = i % D;
        float gv = sGV[r * LD + c], gk = sGK[r * LD + c];
        for (int j = 0; j < kT; ++j) {
          gv = fmaf(sP[r * LDS + j], sdO[j * LD + c], gv);
          gk = fmaf(sS[r * LDS + j], sQ[j * LD + c], gk);
        }
        sGV[r * LD + c] = gv;
        sGK[r * LD + c] = gk;
      }
    }
  }
  __syncthreads();
  float* kbase = dk + b * p.a_sb + hk * p.a_sh;
  float* vbase = dv + b * p.b_sb + hk * p.b_sh;
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (kv0 + r < p.skv) {
      kbase[(long long)(kv0 + r) * p.a_ss + c] = sGK[r * LD + c];
      vbase[(long long)(kv0 + r) * p.b_ss + c] = sGV[r * LD + c];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int b, const BwdParams& p,
                      cudaStream_t stream) {
  if (dtype == 1) {
    using C = DqCfg<D>;
    static bool done = false;
    cudaError_t err = configure(flash_bwd_dq_bf16_kernel<D>, C::bytes, done);
    if (err != cudaSuccess) return err;
    dim3 grid((p.sq + C::BM - 1) / C::BM, p.h, b);
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, C::bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), p);
  } else {
    static bool done = false;
    cudaError_t err = configure(flash_bwd_dq_f32_kernel<D>, F32Cfg<D>::dq_bytes, done);
    if (err != cudaSuccess) return err;
    dim3 grid((p.sq + kT - 1) / kT, p.h, b);
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, F32Cfg<D>::dq_bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int b, int hk,
                       const BwdParams& p, cudaStream_t stream) {
  if (dtype == 1) {
    using C = DkvCfg<D>;
    static bool done = false;
    cudaError_t err = configure(flash_bwd_dkv_bf16_kernel<D>, C::bytes, done);
    if (err != cudaSuccess) return err;
    dim3 grid((p.skv + C::BN - 1) / C::BN, hk, b);
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, C::bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), p);
  } else {
    static bool done = false;
    cudaError_t err = configure(flash_bwd_dkv_f32_kernel<D>, F32Cfg<D>::dkv_bytes, done);
    if (err != cudaSuccess) return err;
    dim3 grid((p.skv + kT - 1) / kT, hk, b);
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, F32Cfg<D>::dkv_bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), p);
  }
  return cudaGetLastError();
}

bool make_params(BwdParams& p, int dtype, int h, int hk, int sq, int skv, float scale,
                 int causal) {
  if (hk <= 0 || h % hk != 0 || (dtype != 0 && dtype != 1)) return false;
  p.h = h;
  p.n_rep = h / hk;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.scale = scale;
  return true;
}

}  // namespace

extern "C" {

// K2. q, dout and dq [b, sq, h, d]; k and v [b, skv, hk, d]; each given by
// its batch, sequence and head strides in elements (the head dim is
// contiguous). lse and delta are float32 [b, h, sq], contiguous. Returns
// the CUDA error code of the launch (0 on success).
int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int dtype, int b, int h, int hk,
                    int sq, int skv, int d,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long do_sb, long long do_ss, long long do_sh,
                    long long dq_sb, long long dq_ss, long long dq_sh,
                    float scale, int causal, void* stream) {
  BwdParams p{};
  if (!make_params(p, dtype, h, hk, sq, skv, scale, causal)) return (int)cudaErrorInvalidValue;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.a_sb = dq_sb; p.a_ss = dq_ss; p.a_sh = dq_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 64: return (int)launch_dq<64>(dtype, q, k, v, dout, l, dl, dq, b, p, s);
    case 128: return (int)launch_dq<128>(dtype, q, k, v, dout, l, dl, dq, b, p, s);
    case 256: return (int)launch_dq<256>(dtype, q, k, v, dout, l, dl, dq, b, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3. As rt_flash_bwd_dq, with dk and dv [b, skv, hk, d] in place of dq.
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int dtype, int b,
                     int h, int hk, int sq, int skv, int d,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long do_sb, long long do_ss, long long do_sh,
                     long long dk_sb, long long dk_ss, long long dk_sh,
                     long long dv_sb, long long dv_ss, long long dv_sh,
                     float scale, int causal, void* stream) {
  BwdParams p{};
  if (!make_params(p, dtype, h, hk, sq, skv, scale, causal)) return (int)cudaErrorInvalidValue;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.a_sb = dk_sb; p.a_ss = dk_ss; p.a_sh = dk_sh;
  p.b_sb = dv_sb; p.b_ss = dv_ss; p.b_sh = dv_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 64: return (int)launch_dkv<64>(dtype, q, k, v, dout, l, dl, dk, dv, b, hk, p, s);
    case 128: return (int)launch_dkv<128>(dtype, q, k, v, dout, l, dl, dk, dv, b, hk, p, s);
    case 256: return (int)launch_dkv<256>(dtype, q, k, v, dout, l, dl, dk, dv, b, hk, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
