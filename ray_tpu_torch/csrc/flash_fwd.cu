// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py:_fwd_kernel, the Pallas forward
// that _flash_fwd launches. It computes O = softmax(scale * Q K^T, masked) V
// with an online softmax. The running max m, the denominator l and the
// output accumulator are float32. On request it also writes the per-row
// log-sum-exp lse = m + log(l). The causal mask keeps k_pos <= q_pos,
// aligned at the top left, as the TPU kernel does. A row with no visible
// key gets output 0 and lse -inf. As on the TPU, the unnormalized
// probabilities are rounded to the input type before the P V product and
// l sums the unrounded ones.
//
// What bounds it on an H100: at the Llama-3-8B attention shape (h 32,
// hk 8, d 128, s 2048, causal) the work is about 34 GFLOP of matrix
// products against about 42 MB of compulsory traffic, roughly 800 FLOP per
// byte. The card's ridge is about 295 FLOP per byte in bf16, so the tensor
// cores bound it, not device memory.
//
// What the design does about that (bf16): a block owns one q tile of one
// head, 4 warps of 32 rows each (16 at d 256, where registers run out).
// Both products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// float32 accumulate) fed by ldmatrix from shared memory, each K/V
// fragment feeding both of a warp's 16-row groups. The scores, the
// probabilities, m, l and the output accumulator never leave registers:
// the score fragment of Q K^T is rescaled, exponentiated (base 2, one
// instruction) and repacked in place as the A operand of P V. K/V tiles
// stream through a two-stage cp.async ring, so the next tile's load
// overlaps this tile's products, and tiles past the causal limit are
// never loaded. Rows are padded by 16 bytes so ldmatrix reads are free of
// bank conflicts. GQA reads kv head h / n_rep through strides, with no
// repeat. The last q tiles, which have the most kv tiles under the causal
// mask, are scheduled first. Not yet used: wgmma, TMA and warp
// specialisation (the route to the rest of the peak).
//
// The float32 path is scalar FMA over shared-memory tiles; it exists so
// the kernel can be held to float32 exactness.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kBM = 64;          // q rows per block of the float32 path
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBM / kWarps;   // float32 path

struct Params {
  int h, n_rep, sq, skv, causal;
  float scale;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
};

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync with register-resident online softmax
// ---------------------------------------------------------------------------

constexpr int kBN = 64;          // kv rows per tile

// Tiles of the bf16 kernel: each warp owns MI m16 row groups (32 rows for
// head dims up to 128, so each K/V fragment read from shared memory feeds
// two products; 16 rows at d 256, where the accumulator alone takes 128
// registers a thread).
template <int D>
struct MmaCfg {
  static constexpr int MI = D <= 128 ? 2 : 1;
  static constexpr int BM = kWarps * 16 * MI;   // q rows per block
  static constexpr int LD = D + 8;   // 16-byte row pad: conflict-free ldmatrix
  static constexpr int bytes = (BM + 4 * kBN) * LD * (int)sizeof(bf16);  // Q + 2 x (K, V)
};

// Start the asynchronous copy of rows [row0, row0 + ROWS) of a [s, D]
// matrix into shared memory; rows at or past `nvalid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, long long row_stride,
                                                int row0, int nvalid) {
  constexpr int LD = MmaCfg<D>::LD;
  constexpr int per_row = D / 8;
  for (int i = threadIdx.x; i < ROWS * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * 8;
    const bool ok = r < nvalid;
    cp_async_16(dst + r * LD + c, ok ? src + (long long)(row0 + r) * row_stride + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      const Params p) {
  constexpr int MI = MmaCfg<D>::MI;
  constexpr int BM = MmaCfg<D>::BM;
  constexpr int LD = MmaCfg<D>::LD;
  constexpr int NT = kBN / 8;    // score n-tiles
  constexpr int OT = D / 8;      // output n-tiles
  constexpr int R = 2 * MI;      // rows this thread holds (g and g + 8 of each group)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;         // [2][kBN][LD]
  bf16* sV = sK + 2 * kBN * LD;    // [2][kBN][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;         // fragment row within an 8-row half
  const int tig = lane & 3;        // fragment column pair
  const int n_qt = (p.sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BM;   // heaviest causal tiles first
  const int w0 = warp * 16 * MI;                      // the warp's first row in the tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.n_rep;
  const bf16* qb = q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = v + b * p.v_sb + hk * p.v_sh;

  int n_kt = (p.skv + kBN - 1) / kBN;
  if (p.causal) n_kt = min(n_kt, (q0 + BM - 1) / kBN + 1);

  load_rows_async<D, BM>(sQ, qb, p.q_ss, q0, min(BM, p.sq - q0));
  if (n_kt > 0) {
    load_rows_async<D, kBN>(sK, kb, p.k_ss, 0, min(kBN, p.skv));
    load_rows_async<D, kBN>(sV, vb, p.v_ss, 0, min(kBN, p.skv));
  }
  cp_async_commit();

  // row r of this thread: group r / 2, upper half when r is odd; its values
  // are elements (r & 1) * 2 and + 1 of the group's fragments
  int row[R];
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = q0 + w0 + (r / 2) * 16 + (r & 1) * 8 + g;
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  float acc[MI][OT][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int t = 0; t < OT; ++t) acc[mi][t][0] = acc[mi][t][1] = acc[mi][t][2] = acc[mi][t][3] = 0.0f;
  // scores go to base 2: exp2 is one instruction, and p is unchanged
  const float scale2 = p.scale * 1.4426950408889634f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {
      const int kv1 = (kt + 1) * kBN;
      load_rows_async<D, kBN>(sK + (stage ^ 1) * kBN * LD, kb, p.k_ss, kv1, min(kBN, p.skv - kv1));
      load_rows_async<D, kBN>(sV + (stage ^ 1) * kBN * LD, vb, p.v_ss, kv1, min(kBN, p.skv - kv1));
    }
    cp_async_commit();
    cp_async_wait<1>();   // everything but the tile just started has landed
    __syncthreads();
    const bf16* cK = sK + stage * kBN * LD;
    const bf16* cV = sV + stage * kBN * LD;

    // S = Q K^T for the warp's rows, in registers; each K fragment read
    // from shared memory feeds all MI row groups
    float s[MI][NT][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int t = 0; t < NT; ++t) s[mi][t][0] = s[mi][t][1] = s[mi][t][2] = s[mi][t][3] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi], sQ + (w0 + mi * 16 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int n0 = 0; n0 < kBN; n0 += 16) {
        uint32_t bk[4];
        ldmatrix_x4(bk, cK + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_16816(s[mi][n0 / 8], a[mi], bk[0], bk[1]);
          mma_16816(s[mi][n0 / 8 + 1], a[mi], bk[2], bk[3]);
        }
      }
    }

    // scale, mask, online softmax (a row's values sit in the 4 threads of
    // its quad, so row reductions are two shuffles)
    const int kv0 = kt * kBN;
    const bool masked = kv0 + kBN > p.skv || (p.causal && kv0 + kBN - 1 > q0 + w0);
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mi + (e >> 1);
          const int col = kv0 + t * 8 + tig * 2 + (e & 1);
          float x = s[mi][t][e] * scale2;
          if (masked && (col >= p.skv || (p.causal && col > row[r]))) x = -INFINITY;
          s[mi][t][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float base[R], corr[R], sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      // a row with no visible key so far keeps p = 0 instead of exp(nan)
      base[r] = (mn == -INFINITY) ? 0.0f : mn;
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = mn;
      sum[r] = 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mi + (e >> 1);
          s[mi][t][e] = exp2f(s[mi][t][e] - base[r]);
          sum[r] += s[mi][t][e];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        acc[mi][t][0] *= corr[2 * mi];
        acc[mi][t][1] *= corr[2 * mi];
        acc[mi][t][2] *= corr[2 * mi + 1];
        acc[mi][t][3] *= corr[2 * mi + 1];
      }
    }

    // O += P V: the score fragments of two adjacent n-tiles are the A
    // fragment of one 16-wide k step, rounded to bf16; each V fragment read
    // from shared memory feeds all MI row groups
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        a[mi][0] = pack_bf16(s[mi][2 * c][0], s[mi][2 * c][1]);
        a[mi][1] = pack_bf16(s[mi][2 * c][2], s[mi][2 * c][3]);
        a[mi][2] = pack_bf16(s[mi][2 * c + 1][0], s[mi][2 * c + 1][1]);
        a[mi][3] = pack_bf16(s[mi][2 * c + 1][2], s[mi][2 * c + 1][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, cV + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_16816(acc[mi][n0 / 8], a[mi], bv[0], bv[1]);
          mma_16816(acc[mi][n0 / 8 + 1], a[mi], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // out = acc / l; lse = m + log(l), with m back in natural-log units
  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row[r] >= p.sq) continue;
    const int mi = r / 2;
    const int e0 = (r & 1) * 2;
    const float ls = (l[r] == 0.0f) ? 1.0f : l[r];
    bf16* orow = o + b * p.o_sb + h * p.o_sh + (long long)row[r] * p.o_ss;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + t * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[mi][t][e0] / ls, acc[mi][t][e0 + 1] / ls);
    if (lse != nullptr && tig == 0)
      lse[((long long)b * p.h + h) * p.sq + row[r]] =
          (l[r] == 0.0f) ? -INFINITY : m[r] * kLn2 + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA over shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kBN32 = 32;

template <int D>
struct F32Smem {
  static constexpr int LD = D + 4;       // Q/K/V tile rows
  static constexpr int LDS = kBN32 + 4;  // scores and probabilities
  static constexpr int LDO = D + 4;      // output accumulator
  static constexpr int k_off = align128(kBM * LD * 4);
  static constexpr int v_off = align128(k_off + kBN32 * LD * 4);
  static constexpr int s_off = align128(v_off + kBN32 * LD * 4);
  static constexpr int p_off = align128(s_off + kBM * LDS * 4);
  static constexpr int o_off = align128(p_off + kBM * LDS * 4);
  static constexpr int m_off = align128(o_off + kBM * LDO * 4);
  static constexpr int l_off = m_off + kBM * 4;
  static constexpr int bytes = align128(l_off + kBM * 4);
};

template <int D, int ROWS>
__device__ void load_tile_f32(float* dst, const float* src, long long row_stride, int row0,
                              int nvalid) {
  constexpr int LD = F32Smem<D>::LD;
  constexpr int per_row = D / 4;
  for (int i = threadIdx.x; i < ROWS * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     const Params p) {
  using S = F32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + S::k_off);
  float* sV = reinterpret_cast<float*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sP = reinterpret_cast<float*>(smem + S::p_off);
  float* sO = reinterpret_cast<float*>(smem + S::o_off);
  float* sM = reinterpret_cast<float*>(smem + S::m_off);
  float* sL = reinterpret_cast<float*>(smem + S::l_off);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_qt = (p.sq + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.n_rep;
  const float* qb = q + b * p.q_sb + h * p.q_sh;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh;

  load_tile_f32<D, kBM>(sQ, qb, p.q_ss, q0, min(kBM, p.sq - q0));
  for (int i = threadIdx.x; i < kBM * S::LDO; i += kThreads) sO[i] = 0.0f;
  if (threadIdx.x < kBM) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  int n_kt = (p.skv + kBN32 - 1) / kBN32;
  if (p.causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBN32 + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int kv0 = kt * kBN32;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile_f32<D, kBN32>(sK, kb, p.k_ss, kv0, min(kBN32, p.skv - kv0));
    load_tile_f32<D, kBN32>(sV, vb, p.v_ss, kv0, min(kBN32, p.skv - kv0));
    __syncthreads();
    // scores: lane owns kv column `lane` for the warp's 16 rows
    {
      float a[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) a[r] = 0.0f;
      const float* kr = sK + lane * S::LD;
      for (int kk = 0; kk < D; ++kk) {
        const float kv = kr[kk];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          a[r] = fmaf(sQ[(warp * kRowsPerWarp + r) * S::LD + kk], kv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) sS[(warp * kRowsPerWarp + r) * S::LDS + lane] = a[r];
    }
    __syncwarp();
    // online softmax, one row at a time
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int kpos = kv0 + lane;
      const bool ok = kpos < p.skv && (!p.causal || kpos <= q0 + r);
      const float sv = ok ? sS[r * S::LDS + lane] * p.scale : -INFINITY;
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float base = (m_new == -INFINITY) ? 0.0f : m_new;
      const float e = expf(sv - base);
      sP[r * S::LDS + lane] = e;
      const float sum = warp_sum(e);
      const float corr = expf(m_prev - base);
      for (int j = lane; j < D; j += 32) sO[r * S::LDO + j] *= corr;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
      }
      __syncwarp();
    }
    // O += P V
    for (int j = lane; j < D; j += 32) {
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        float a = 0.0f;
        for (int c = 0; c < kBN32; ++c) a = fmaf(sP[row * S::LDS + c], sV[c * S::LD + j], a);
        sO[row * S::LDO + j] += a;
      }
    }
    __syncwarp();
  }

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int qpos = q0 + r;
    if (qpos >= p.sq) break;
    const float l = sL[r];
    const float l_safe = (l == 0.0f) ? 1.0f : l;
    float* orow = o + b * p.o_sb + h * p.o_sh + qpos * p.o_ss;
    for (int j = lane; j < D; j += 32) orow[j] = sO[r * S::LDO + j] / l_safe;
    if (lse != nullptr && lane == 0)
      lse[((long long)b * p.h + h) * p.sq + qpos] = (l == 0.0f) ? -INFINITY : sM[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                   int b, const Params& p, cudaStream_t stream) {
  if (dtype == 1) {
    using C = MmaCfg<D>;
    static bool done = false;
    cudaError_t err = configure(flash_fwd_bf16_kernel<D>, C::bytes, done);
    if (err != cudaSuccess) return err;
    dim3 grid((p.sq + C::BM - 1) / C::BM, p.h, b);
    flash_fwd_bf16_kernel<D><<<grid, kThreads, C::bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, p);
  } else {
    static bool done = false;
    cudaError_t err = configure(flash_fwd_f32_kernel<D>, F32Smem<D>::bytes, done);
    if (err != cudaSuccess) return err;
    dim3 grid((p.sq + kBM - 1) / kBM, p.h, b);
    flash_fwd_f32_kernel<D><<<grid, kThreads, F32Smem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [b, sq, h, d], k and v [b, skv, hk, d], o like q, each given by its
// batch, sequence and head strides in elements (the head dim is
// contiguous). lse is float32 [b, h, sq], or null. Returns the CUDA error
// code of the launch (0 on success).
int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                 int b, int h, int hk, int sq, int skv, int d,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale, int causal, void* stream) {
  if (hk <= 0 || h % hk != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Params p;
  p.h = h;
  p.n_rep = h / hk;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64: return (int)launch<64>(dtype, q, k, v, o, l, b, p, s);
    case 128: return (int)launch<128>(dtype, q, k, v, o, l, b, p, s);
    case 256: return (int)launch<256>(dtype, q, k, v, o, l, b, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
