// Flash-attention backward for Hopper (sm_90a): K2 and K3 in one kernel.
//
// Replaces: ray_tpu/ops/flash_attention.py:_bwd_dq_kernel (K2) and
// :_bwd_dkv_kernel (K3), the Pallas kernels that _flash_bwd launches.
// The probabilities are recomputed from the forward's log-sum-exp instead
// of read from a stored [sq, skv] matrix:
//   S = scale * Q K^T (masked), P = exp(S - lse), dP = dO V^T,
//   dS = P * (dP - delta) * scale, with delta = rowsum(dO * O),
//   dQ = dS K; dV = P^T dO and dK = dS^T Q, summed over the GQA group.
// As on the TPU, P is rounded to dO's type before dV and dS to K's (Q's)
// type before dQ (dK); every product accumulates in float32. A row whose
// lse is -inf (no visible key) gets a zero gradient. The causal mask keeps
// k_pos <= q_pos, aligned at the top left, as the forward does.
//
// What bounds it on an H100: at the Llama-3-8B training shape (b 2, h 32,
// hk 8, d 128, s 2048, causal) the five products over the causal pairs
// (S, dP, dV, dK, dQ: 172 GFLOP) against about 135 MB of compulsory
// traffic (q, k, v, out, dO and lse read once; dq, dk, dv written once),
// some 1,300 FLOP per byte, far above the card's ridge of about 295 in
// bf16. The tensor cores bound it, and on Hopper only wgmma reaches their
// full rate. Two separate kernels (K2 for dQ, K3 for dK and dV) would
// each recompute S and dP: seven products, and Q, K, V and dO read twice.
//
// What the design does about that (bf16; FA3's shape): three launches.
// - A preprocess computes delta = rowsum(dO * O) (summed in float64,
//   rounded to float32), writes lse in base 2 (a row with lse -inf as
//   +inf, so its probabilities are 0), both padded to whole 64-row q
//   tiles, and zeroes the float32 dQ accumulator.
// - The main kernel: a CTA owns one kv tile of one (batch, kv head), the
//   heaviest causal tiles first (the first kv tiles see the most q tiles;
//   the hardware hands out CTAs in order, so the long ones start first).
//   It walks the n_rep q heads of the kv head's group and, in each, the
//   64-row q tiles from the last down to the causal start, so dK and dV are
//   summed over the whole group in float32 registers (the TPU kernel's
//   in-kernel group sum) and written once: deterministic. The CTAs of one
//   (batch, kv head) start together at the same last tile, so their dQ
//   adds and Q and dO loads meet in L2. Three warpgroups:
//   - warpgroup 0 is the producer (setmaxnreg down to 24): one thread
//     loads K and V once by TMA, then streams each q tile's Q and dO (TMA,
//     128-byte swizzle, 4-D tensor maps over the strided [b, s, h, d]
//     views) and its lse and delta rows (bulk copies) through a ring of
//     stages with full and empty mbarriers;
//   - warpgroups 1 and 2 are consumers (setmaxnreg up to 240). At d 64 and
//     128 each owns 64 of the tile's 128 kv rows. For each q tile: S^T =
//     K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
//     K-major in shared memory (transposed, so a warpgroup's rows are kv
//     rows); P^T and dS^T are computed on the accumulator fragments (the
//     mask, on the tiles that cross the diagonal or the end of kv only, a
//     compare and a select a score); packed to bf16 they are the register
//     A operands of dV += P^T dO and dK += dS^T Q (m64n{64,128}k16, dO and
//     Q read MN-major).
//   - d 256: dK and dV of 64 kv rows at full width do not fit in one
//     warpgroup's registers beside the score tiles, so both consumers own
//     the tile's 64 kv rows and each half of dK's and dV's columns (128
//     floats a thread); each computes S^T and dP^T for half of the q tile
//     (m64n32), and they swap P^T and dS^T through shared memory, from
//     where dV and dK read them (m64n128k16, both operands in shared
//     memory): FA3's split at this width.
// - dQ: each consumer writes dS^T (bf16) to shared memory, and its share
//   of the tile's dQ = dS K is a wgmma with dS read MN-major from there and
//   K read MN-major: at d 128 the two consumers join on a named barrier
//   and split dQ's columns, each reading both halves of dS; at d 64 each
//   takes its own 64 kv rows and all columns; at d 256 each its half of
//   the columns, in two passes of 64. The float32 share is staged in
//   shared memory in the accumulator's fragment order and added into the
//   float32 dQ buffer by one bulk reduce-add (cp.reduce.async.bulk
//   .add.f32), which overlaps the next q tile; at d 256, where the staging
//   tile does not fit, by atomic adds from registers. dQ's summation order
//   across CTAs changes from run to run.
// - A postprocess converts dQ to bf16 in the caller's layout.
// - Rules of the machinery that the code keeps (each broke K1 once):
//   nothing between a wgmma and its wait may branch divergently or write
//   the wgmma's registers, or ptxas serializes the products (C7520,
//   C7513); a trap on the consumers' path keeps them within the launch
//   register count despite setmaxnreg (spills, C7512). Hence predicated
//   barrier arrivals, the asm spin wait, and the select for the mask.
//
// The float32 path is scalar FMA over shared-memory tiles (two kernels
// after the same preprocess); it exists so the design can be held to
// float32 exactness.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ long long row_index(int b, int h, int nh, int s, int row) {
  return ((long long)b * nh + h) * s + row;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Preprocess: delta, lse in base 2, the zeroed dQ accumulator
// ---------------------------------------------------------------------------

struct PreParams {
  int b, h, sq, ld;   // ld: rows of lse2 and delta a head (sq padded, or sq)
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
};

// V consecutive elements of a row, loaded at once (at most 16 bytes a load)
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Vec {
  T v[V];
};

// One warp a row of [b, h, ld]: delta = rowsum(dO * O) (each lane D / 32
// adjacent columns), and lse2 = lse * log2(e) (lse -inf as +inf); rows at
// or past sq get delta 0 and lse2 +inf. Every thread also zeroes its share
// of `zero` (n_zero float4s: the dQ accumulator, or none). delta is summed
// in float64, so it is the float32 rounding of the exact sum whatever the
// order: dS = P (dP - delta) cancels, and a float32 sum in another order
// than the plain version's would move dQ by more than the float32 path's
// limit.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_pre_kernel(const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
                     float* __restrict__ lse2, float* __restrict__ delta, float4* __restrict__ zero,
                     long long n_zero, const PreParams p) {
  constexpr int V = D / 32;
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (r < (long long)p.b * p.h * p.ld) {
    const int bh = (int)(r / p.ld), row = (int)(r % p.ld);
    const int b = bh / p.h, h = bh % p.h;
    double acc = 0.0;
    if (row < p.sq) {   // the same for the whole warp
      const Vec<T, V> o = *reinterpret_cast<const Vec<T, V>*>(out + b * p.o_sb + h * p.o_sh + row * p.o_ss +
                                                              lane * V);
      const Vec<T, V> g = *reinterpret_cast<const Vec<T, V>*>(dout + b * p.do_sb + h * p.do_sh +
                                                              row * p.do_ss + lane * V);
#pragma unroll
      for (int j = 0; j < V; ++j) acc = fma((double)to_float(o.v[j]), (double)to_float(g.v[j]), acc);
      acc = warp_sum(acc);
    }
    if (lane == 0) {
      const float x = row < p.sq ? lse[(long long)bh * p.sq + row] : -INFINITY;
      delta[r] = (float)acc;
      lse2[r] = x == -INFINITY ? INFINITY : x * kLog2e;
    }
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_zero;
       i += (long long)gridDim.x * blockDim.x)
    zero[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// bf16: the fused kernel (TMA ring, warp-specialised wgmma)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kFusedThreads = 3 * kWgThreads;   // producer + two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// 65,536 registers over 384 threads: ptxas gives each thread 168 at launch,
// which setmaxnreg moves from the producer to the consumers. Fewer at
// launch and the consumers' setmaxnreg.inc would wait forever.
constexpr int kLaunchRegs = (2 * kConsumerRegs + kProducerRegs) / 3;
constexpr int kConsumerWarps = 8;   // arrivals that free a stage
constexpr int kBM = 64;             // q rows a step

// Tiles and shared memory (at most 227 KB), each tile 1024-byte aligned:
// K and V of the CTA (BN rows), the Q and dO ring, the score tile
// ([128][64] bf16: dS^T of the 128 kv rows at d <= 128, or P^T over dS^T
// of the 64 at d 256; double-buffered where the consumers read each
// other's), the dQ staging tiles (one a consumer, [NQ / 8][128 threads][4]
// float32), lse2 and delta of each stage, the barriers. d 64: 16 + 16 +
// 2 x 16 + 16 + 32 KB; d 128: 32 + 32 + 2 x 32 + 2 x 16 + 32 KB; d 256:
// 32 + 32 + 2 x 64 + 2 x 16 KB.
template <int D>
struct BwdCfg {
  // d <= 128: the consumers own 64 kv rows each and all of dK's and dV's
  // columns, P^T and dS^T stay in registers. d 256: both own the tile's 64
  // kv rows and half of the columns; each computes S^T and dP^T for half of
  // the q tile (m64n32) and they swap P^T and dS^T through shared memory:
  // the float32 dK and dV (128 floats a thread) leave no room for more.
  static constexpr bool kRowSplit = D <= 128;
  static constexpr int BN = kRowSplit ? 128 : 64;      // kv rows a CTA
  static constexpr int SN = kRowSplit ? kBM : kBM / 2; // q columns of a consumer's S^T
  static constexpr int DC = kRowSplit ? D : D / 2;     // dK/dV columns a consumer
  static constexpr int NQ = D == 64 ? 64 : D / 2;      // dQ columns a consumer
  static constexpr int NW = 64;                        // dQ columns a product (a pass)
  static constexpr int KQ = D == 128 ? 128 : 64;       // kv rows of a consumer's dQ product
  static constexpr bool kJoin = D >= 128;              // a consumer reads the other's scores
  static constexpr bool kStaged = D <= 128;            // dQ by bulk reduce (NQ == NW), else atomics
  static constexpr int kStages = 2;
  static constexpr int kDsBufs = kJoin ? 2 : 1;
  static constexpr int kBoxes = D / 64;                // 64-column swizzled boxes a row
  static constexpr uint32_t kv_bytes = BN * D * 2;     // K or V
  static constexpr uint32_t q_bytes = kBM * D * 2;     // one Q or dO stage
  static constexpr uint32_t row_bytes = kBM * 4;       // one stage's lse2 or delta
  static constexpr int v_off = kv_bytes;
  static constexpr int q_off = 2 * kv_bytes;
  static constexpr int do_off = q_off + kStages * q_bytes;
  static constexpr int ds_off = do_off + kStages * q_bytes;
  static constexpr int stg_off = ds_off + kDsBufs * 128 * 64 * 2;
  static constexpr int l_off = stg_off + (kStaged ? 2 * kBM * NQ * 4 : 0);
  static constexpr int bar_off = l_off + 2 * kStages * row_bytes;
  static constexpr int n_bars = 1 + 2 * kStages;       // K/V full; each stage full and empty
  static constexpr int bytes = bar_off + n_bars * 8 + 1024;   // + slack to align to 1024
};

struct FusedParams {
  int b, h, hk, n_rep, sq, skv, causal, n_qt, ld;   // ld = n_qt * 64
  float scale;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
};

// S^T (64 kv rows x SN q rows) = A B^T: A a consumer's rows of K or V
// (boxes of BN rows), B SN rows of the stage's Q or dO (boxes of 64 rows),
// both K-major, d / 16 k16 steps. Issued, not waited for.
template <int D, int BN, int SN>
__device__ __forceinline__ void issue_scores(float (&s)[SN / 2], const bf16* a, const bf16* bq) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // box kk / 4; a k16 step inside the 128-byte row moves 32 bytes
    const int col = (kk % 4) * 16;
    const uint64_t da = hopper::desc_sw128(a + (kk / 4) * BN * 64 + col, 16, 1024);
    const uint64_t db = hopper::desc_sw128(bq + (kk / 4) * kBM * 64 + col, 16, 1024);
    hopper::Wgmma<SN>::template ss<0, 0>(s, da, db, kk > 0 ? 1 : 0);
  }
}

// acc (64 kv rows x DC) += A (64 kv x 64 q) * B (the stage's dO or Q from
// its column box, MN-major: LBO steps from one 64-column box to the next),
// 4 k16 steps. A in registers (rs), or a [64][64] score tile in shared
// memory, K-major (ss). Issued, not waited for.
template <int DC>
__device__ __forceinline__ void issue_acc(float (&acc)[DC / 2], const uint32_t (&a)[4][4], const bf16* b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t db = hopper::desc_sw128(b + c * 16 * 64, kBM * 128, 1024);
    hopper::Wgmma<DC>::template rs<1>(acc, a[c], db, 1);
  }
}
template <int DC>
__device__ __forceinline__ void issue_acc(float (&acc)[DC / 2], const bf16* a, const bf16* b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t da = hopper::desc_sw128(a + c * 16, 16, 1024);
    const uint64_t db = hopper::desc_sw128(b + c * 16 * 64, kBM * 128, 1024);
    hopper::Wgmma<DC>::template ss<0, 1>(acc, da, db, 1);
  }
}

// A 64 x N score fragment rounded to bf16 as the register A operand of
// N / 16 k16 steps: the fragments of two adjacent 8-column tiles make one
// step.
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    a[c][0] = pack_bf16(x[8 * c + 0], x[8 * c + 1]);
    a[c][1] = pack_bf16(x[8 * c + 2], x[8 * c + 3]);
    a[c][2] = pack_bf16(x[8 * c + 4], x[8 * c + 5]);
    a[c][3] = pack_bf16(x[8 * c + 6], x[8 * c + 7]);
  }
}

// A packed fragment of NS k16 steps into a swizzled score tile of 64
// bf16 a row (16-byte chunk c of row r at chunk c ^ (r % 8): a warp's
// stores hit 32 distinct banks), from 16-byte chunk chunk0 on; row0 =
// this thread's first row, a multiple of 8 plus g.
template <int NS>
__device__ __forceinline__ void store_scores(bf16* tile, const uint32_t (&a)[NS][4], int row0, int chunk0, int g,
                                             int t) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const int lo = ((chunk0 + 2 * c) ^ g) * 16 + 4 * t, hi = ((chunk0 + 2 * c + 1) ^ g) * 16 + 4 * t;
    *reinterpret_cast<uint32_t*>(base + row0 * 128 + lo) = a[c][0];
    *reinterpret_cast<uint32_t*>(base + (row0 + 8) * 128 + lo) = a[c][1];
    *reinterpret_cast<uint32_t*>(base + row0 * 128 + hi) = a[c][2];
    *reinterpret_cast<uint32_t*>(base + (row0 + 8) * 128 + hi) = a[c][3];
  }
}

// Two floats from shared memory, loaded where the call stands: a volatile
// load is not hoisted, so the 16 lse2 (or delta) values of a step are not
// all held in registers at once (the d 128 consumers have none to spare;
// measured 3% faster than letting the compiler batch the loads)
__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(hopper::smem_u32(p)));
  return v;
}

template <int D>
__global__ void __launch_bounds__(kFusedThreads, 1)
flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse2, const float* __restrict__ delta,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      const FusedParams p) {
  using C = BwdCfg<D>;
  constexpr int BN = C::BN, S = C::kStages, SN = C::SN, NQ = C::NQ, NW = C::NW, DC = C::DC;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: every box starts on that
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sK = reinterpret_cast<bf16*>(smem);                // [kBoxes][BN][64]
  bf16* sV = reinterpret_cast<bf16*>(smem + C::v_off);     // [kBoxes][BN][64]
  bf16* sQ = reinterpret_cast<bf16*>(smem + C::q_off);     // [S][kBoxes][64][64]
  bf16* sdO = reinterpret_cast<bf16*>(smem + C::do_off);   // [S][kBoxes][64][64]
  bf16* sdS = reinterpret_cast<bf16*>(smem + C::ds_off);   // [kDsBufs][128][64]
  float* sStg = reinterpret_cast<float*>(smem + C::stg_off);   // [2][NQ / 8][128][4]
  float* sL = reinterpret_cast<float*>(smem + C::l_off);   // [S][64] lse2
  float* sD = sL + S * kBM;                                // [S][64] delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  // the CTA's kv tile (the first ones, heaviest under causal, first), batch
  // and kv head; its q tiles: every q head of the group, from the first
  // tile that ends at or past kv0 (the earlier ones see none of its keys)
  const int n_bh = p.b * p.hk;
  const int kv0 = (int)(blockIdx.x / n_bh) * BN;
  const int hk = (int)(blockIdx.x % n_bh) % p.hk;
  const int b = (int)(blockIdx.x % n_bh) / p.hk;
  const int qt0 = p.causal ? min(kv0 / kBM, p.n_qt) : 0;
  const int per_head = p.n_qt - qt0;
  const int n_it = p.n_rep * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumerWarps);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // One if/else on the warpgroup that never rejoins: setmaxnreg needs it.
  if (threadIdx.x < kWgThreads) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensormap(&tm_q);
      hopper::prefetch_tensormap(&tm_k);
      hopper::prefetch_tensormap(&tm_v);
      hopper::prefetch_tensormap(&tm_do);
      hopper::mbar_arrive_expect_tx(kv_full, 2 * C::kv_bytes);
#pragma unroll
      for (int j = 0; j < C::kBoxes; ++j) {
        hopper::tma_load_4d(sK + j * BN * 64, &tm_k, kv_full, j * 64, kv0, hk, b);
        hopper::tma_load_4d(sV + j * BN * 64, &tm_v, kv_full, j * 64, kv0, hk, b);
      }
      // the consumers' order: q head by q head, each from its last tile
      for (int it = 0; it < n_it; ++it) {
        const int st = it % S;
        const int hq = hk * p.n_rep + it / per_head;
        const int q0 = (p.n_qt - 1 - it % per_head) * kBM;
        hopper::mbar_wait(empty + st, ((it / S) & 1) ^ 1);   // the consumers are done with the stage
        hopper::mbar_arrive_expect_tx(full + st, 2 * C::q_bytes + 2 * C::row_bytes);
#pragma unroll
        for (int j = 0; j < C::kBoxes; ++j) {
          hopper::tma_load_4d(sQ + st * kBM * D + j * kBM * 64, &tm_q, full + st, j * 64, q0, hq, b);
          hopper::tma_load_4d(sdO + st * kBM * D + j * kBM * 64, &tm_do, full + st, j * 64, q0, hq, b);
        }
        const long long row = ((long long)b * p.h + hq) * p.ld + q0;
        hopper::bulk_load(sL + st * kBM, lse2 + row, C::row_bytes, full + st);
        hopper::bulk_load(sD + st * kBM, delta + row, C::row_bytes, full + st);
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / kWgThreads - 1;
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kv_off = C::kRowSplit ? 64 * w : 0;    // the consumer's kv rows in the tile
    const int qoff = C::kRowSplit ? 0 : SN * w;      // its q columns of S^T in the q tile
    const int col0 = C::kRowSplit ? 0 : w * DC;      // its dK/dV columns
    // its dQ product: columns qcol0.., over dS^T rows ds_row0.. and K rows
    // k_row0.. (d 256: dS^T sits below P^T in the score tile)
    const int qcol0 = D == 64 ? 0 : w * NQ;
    const int ds_row0 = D == 64 ? 64 * w : D == 128 ? 0 : 64;
    const int k_row0 = D == 64 ? 64 * w : 0;
    const int part = D == 64 ? 0 : w;                // its share of a q tile in dq_acc
    const float scale2 = p.scale * kLog2e;
    // this thread's kv rows: the first q position that sees each (a key
    // past skv none, every key all under no causal mask)
    int krow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv0 + kv_off + 16 * warp + g + 8 * r;
      krow[r] = row >= p.skv ? (1 << 30) : p.causal ? row : -(1 << 30);
    }
    // the q tiles that need the mask, the last of each head's walk: all of
    // them for a kv tile that runs past skv, else under causal those that
    // start before the tile's last key (rows past sq need none: their lse2
    // is +inf, so their P is 0)
    const int qt_open = kv0 + BN > p.skv ? p.n_qt
                        : p.causal       ? min(p.n_qt, (kv0 + BN - 1 + kBM - 1) / kBM)
                                         : 0;

    float dk_acc[DC / 2], dv_acc[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    float s[SN / 2], dp[SN / 2], dq[NW / 2];
    uint32_t pa[SN / 16][4], da[SN / 16][4];
    const bf16* kw = sK + kv_off * 64;
    const bf16* vw = sV + kv_off * 64;
    hopper::mbar_wait(kv_full, 0);

    // Step it of the walk (q tile qt of q head hq); kMask adds the mask as
    // a compare and a select a score.
    auto step = [&](int it, int hq, int qt, auto mask) {
      constexpr bool kMask = decltype(mask)::value;
      const int st = it % S;
      const int q0 = qt * kBM + qoff;   // the first q column of this consumer's S^T
      const bf16* qs = sQ + st * kBM * D;
      const bf16* dos = sdO + st * kBM * D;
      const float* ls = sL + st * kBM + qoff;
      const float* dls = sD + st * kBM + qoff;
      bf16* ds = sdS + (it % C::kDsBufs) * 128 * 64;

      hopper::mbar_wait(full + st, (it / S) & 1);
      hopper::wgmma_fence();
      issue_scores<D, BN, SN>(s, kw, qs + qoff * 64);
      hopper::wgmma_commit();
      issue_scores<D, BN, SN>(dp, vw, dos + qoff * 64);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // S^T done; dP^T may still run
      hopper::fence_operand(s);
      // P^T = 2^(S^T scale log2(e) - lse2), 0 where the key is hidden
#pragma unroll
      for (int i = 0; i < SN / 8; ++i) {
        const float2 l = lds_f2(ls + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = exp2_approx(s[4 * i + e] * scale2 - ((e & 1) ? l.y : l.x));
          if constexpr (kMask)
            s[4 * i + e] = (q0 + 8 * i + 2 * t + (e & 1) >= krow[e >> 1]) ? x : 0.0f;
          else
            s[4 * i + e] = x;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
      // dS^T = P^T (dP^T - delta) scale, as P^T (dP^T scale - delta scale)
#pragma unroll
      for (int i = 0; i < SN / 8; ++i) {
        const float2 dl = lds_f2(dls + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * i + e] = s[4 * i + e] * fmaf(dp[4 * i + e], p.scale, -((e & 1) ? dl.y : dl.x) * p.scale);
      }
      pack_a<SN>(s, pa);
      pack_a<SN>(dp, da);
      if constexpr (C::kRowSplit) {
        // dV += P^T dO and dK += dS^T Q from registers; dS^T to shared
        // memory for dQ
        store_scores<SN / 16>(ds, da, 64 * w + 16 * warp + g, 0, g, t);
        hopper::fence_proxy_async();   // dS^T is read by wgmma (the async proxy)
        hopper::wgmma_fence();
        issue_acc<DC>(dv_acc, pa, dos);
        issue_acc<DC>(dk_acc, da, qs);
        hopper::wgmma_commit();
        // every row of dS^T that this consumer's dQ reads is written
        if constexpr (C::kJoin)
          hopper::named_bar_sync(1, 2 * kWgThreads);
        else
          hopper::named_bar_sync(3 + w, kWgThreads);
      } else {
        // both halves of P^T and dS^T to shared memory, then dV and dK of
        // this consumer's columns from there
        store_scores<SN / 16>(ds, pa, 16 * warp + g, 2 * (SN / 16) * w, g, t);
        store_scores<SN / 16>(ds + 64 * 64, da, 16 * warp + g, 2 * (SN / 16) * w, g, t);
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1, 2 * kWgThreads);
        hopper::wgmma_fence();
        issue_acc<DC>(dv_acc, ds, dos + (col0 / 64) * kBM * 64);
        issue_acc<DC>(dk_acc, ds + 64 * 64, qs + (col0 / 64) * kBM * 64);
        hopper::wgmma_commit();
      }
      // the share into dq_acc, in the fragment order: float4 i of thread
      // tid (rows g and g + 8, columns 8 i + 2 t, + 1) at (i * 128 + tid) * 4
      float* gdq = dq_acc + ((long long)(b * p.h + hq) * p.n_qt + qt) * (kBM * D) + part * (kBM * NQ);
      // dQ share = dS K, NW columns a pass: dS^T read MN-major (q
      // contiguous), K MN-major
#pragma unroll
      for (int hh = 0; hh < NQ / NW; ++hh) {
        if (hh > 0) hopper::wgmma_fence();   // the previous pass's adds read dq
#pragma unroll
        for (int kk = 0; kk < C::KQ / 16; ++kk) {
          const uint64_t dsa = hopper::desc_sw128(ds + (ds_row0 + 16 * kk) * 64, 128 * 128, 1024);
          const uint64_t dkb = hopper::desc_sw128(
              sK + ((qcol0 + hh * NW) / 64) * BN * 64 + (k_row0 + 16 * kk) * 64, BN * 128, 1024);
          hopper::Wgmma<NW>::template ss<1, 1>(dq, dsa, dkb, kk > 0 ? 1 : 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(dq);
        if (hh == 0) {
          hopper::fence_operand(dk_acc);
          hopper::fence_operand(dv_acc);
          hopper::mbar_arrive_if(empty + st, lane == 0);
        }
        if constexpr (C::kStaged) {   // one pass
          float* stg = sStg + w * (kBM * NQ);
          const bool leader = tid == 0;
          if (leader) hopper::tma_store_wait_read();   // the previous reduce has read the tile
          hopper::named_bar_sync(3 + w, kWgThreads);
#pragma unroll
          for (int i = 0; i < NW / 8; ++i)
            *reinterpret_cast<float4*>(stg + (i * 128 + tid) * 4) =
                make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
          hopper::fence_proxy_async();
          hopper::named_bar_sync(3 + w, kWgThreads);
          if (leader) {
            hopper::bulk_reduce_add_f32(gdq, stg, kBM * NQ * 4);
            hopper::tma_store_commit();
          }
        } else {
#pragma unroll
          for (int i = 0; i < NW / 2; ++i)
            atomicAdd(gdq + ((hh * NW / 8 + i / 4) * 128 + tid) * 4 + i % 4, dq[i]);
        }
      }
    };

    // In each q head the walk runs from the last q tile down to the causal
    // start: the CTAs of one (batch, kv head) start together at the same
    // tile, so their dQ adds and their Q and dO loads meet in L2 (the dQ
    // buffer, 67 MB at the training shape, does not fit in it).
    int it = 0;
    for (int rep = 0; rep < p.n_rep; ++rep) {
      const int hq = hk * p.n_rep + rep;
      int qt = p.n_qt - 1;
      for (; qt >= qt_open; --qt) step(it++, hq, qt, std::false_type{});
      for (; qt >= qt0; --qt) step(it++, hq, qt, std::true_type{});
    }
    // the last reduce is complete before the kernel ends
    if (C::kStaged && tid == 0) hopper::tma_store_wait_all();

    // dK and dV, once, in bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv0 + kv_off + 16 * warp + g + 8 * r;
      if (row >= p.skv) continue;
      bf16* krow_p = dk + b * p.dk_sb + hk * p.dk_sh + (long long)row * p.dk_ss + col0;
      bf16* vrow_p = dv + b * p.dv_sb + hk * p.dv_sh + (long long)row * p.dv_ss + col0;
#pragma unroll
      for (int i = 0; i < DC / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(krow_p + 8 * i + 2 * t) =
            __floats2bfloat162_rn(dk_acc[4 * i + 2 * r], dk_acc[4 * i + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow_p + 8 * i + 2 * t) =
            __floats2bfloat162_rn(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Postprocess: dQ to bf16 in the caller's layout
// ---------------------------------------------------------------------------

struct PostParams {
  int h, sq, n_qt;
  long long dq_sb, dq_ss, dq_sh;
};

// One block a share of dq_acc (kBM q rows x NQ columns, in the main
// kernel's fragment order): read in that order, one float4 a thread,
// rearranged by rows in shared memory, written as bf16, 8 columns (16
// bytes) a thread, so both sides are coalesced.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_post_kernel(const float4* __restrict__ acc, bf16* __restrict__ dq, const PostParams p) {
  constexpr int NQ = BwdCfg<D>::NQ;
  constexpr int LDR = NQ + 8;   // row stride in floats: 16-byte rows, float2 stores spread over the banks
  __shared__ __align__(16) float rows[kBM * LDR];
  const int part = (int)(blockIdx.x % (D / NQ));
  const long long tile = blockIdx.x / (D / NQ);
  const int bh = (int)(tile / p.n_qt), qt = (int)(tile % p.n_qt);
  const float4* src = acc + (long long)blockIdx.x * (kBM * NQ / 4);
  for (int k = threadIdx.x; k < kBM * NQ / 4; k += blockDim.x) {
    const float4 v = src[k];   // float4 c of thread tid: rows g and g + 8, columns 8 c + 2 t, + 1
    const int c = k / 128, tid = k % 128;
    const int row = 16 * (tid / 32) + (tid % 32) / 4, col = 8 * c + 2 * (tid % 4);
    *reinterpret_cast<float2*>(rows + row * LDR + col) = make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(rows + (row + 8) * LDR + col) = make_float2(v.z, v.w);
  }
  __syncthreads();
  bf16* base = dq + (bh / p.h) * p.dq_sb + (bh % p.h) * p.dq_sh + part * NQ;
  for (int k = threadIdx.x; k < kBM * NQ / 8; k += blockDim.x) {
    const int row = k / (NQ / 8), col = k % (NQ / 8) * 8;
    const int q = qt * kBM + row;
    if (q >= p.sq) continue;
    const float4 lo = *reinterpret_cast<const float4*>(rows + row * LDR + col);
    const float4 hi = *reinterpret_cast<const float4*>(rows + row * LDR + col + 4);
    const uint4 out = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                                 pack_bf16(hi.z, hi.w));
    *reinterpret_cast<uint4*>(base + q * p.dq_ss + col) = out;
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA over shared-memory tiles
// ---------------------------------------------------------------------------

struct BwdParams {
  int h, n_rep, sq, skv, causal;
  float scale;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long a_sb, a_ss, a_sh;   // dq (dQ kernel) or dk (dK/dV kernel)
  long long b_sb, b_ss, b_sh;   // dv (dK/dV kernel)
};

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

// Every tensor of the backward: its pointer and its (batch, sequence,
// head) element strides.
struct Tensors {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* work;
  void *dq, *dk, *dv;
  long long q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
};

// The preprocess into work: lse2 [b, h, ld], delta [b, h, ld]; zeroes
// n_zero float4s at `zero`.
template <typename T, int D>
int launch_pre(const Tensors& x, int b, int h, int sq, int ld, float4* zero, long long n_zero,
               cudaStream_t stream) {
  const PreParams pp{b, h, sq, ld, x.o_s[0], x.o_s[1], x.o_s[2], x.do_s[0], x.do_s[1], x.do_s[2]};
  const long long rows = (long long)b * h * ld;
  if (rows == 0) return 0;
  flash_bwd_pre_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(x.out), static_cast<const T*>(x.dout), x.lse, x.work, x.work + rows, zero, n_zero,
      pp);
  return (int)cudaGetLastError();
}

// A tensor map over a [b, s, heads, d] bf16 view (4-D: d, s, heads,
// batch) from its element strides, read in boxes of [rows][64].
template <int D>
int encode(CUtensorMap* map, const void* base, int s, int heads, int b, const long long (&str)[3], int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)s, (uint64_t)heads, (uint64_t)b};
  const uint64_t bytes[3] = {2ull * str[1], 2ull * str[2], 2ull * str[0]};
  return hopper::encode_bf16_sw128(map, base, dims, bytes, rows);
}

// bf16: preprocess, the fused kernel, postprocess. Returns 0, a CUDA
// error, or hopper::kTensorMapError + the CUresult of a failed encode.
template <int D>
int launch_bf16(const Tensors& x, int b, int h, int hk, int sq, int skv, float scale, int causal,
                cudaStream_t stream) {
  using C = BwdCfg<D>;
  const int n_qt = (sq + kBM - 1) / kBM;
  const int ld = n_qt * kBM;
  const long long rows = (long long)b * h * ld;
  float* dq_acc = x.work + 2 * rows;
  int e = launch_pre<bf16, D>(x, b, h, sq, ld, reinterpret_cast<float4*>(dq_acc), rows * D / 4, stream);
  if (e != 0 || rows == 0) return e;

  auto kernel = flash_bwd_bf16_kernel<D>;
  static bool done = false;
  static int regs = 0;
  cudaError_t err = configure(kernel, C::bytes, done);
  if (err != cudaSuccess) return (int)err;
  if (regs == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    regs = attr.numRegs;
  }
  if (regs < kLaunchRegs) return (int)cudaErrorLaunchOutOfResources;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if ((e = encode<D>(&tm_q, x.q, sq, h, b, x.q_s, kBM)) != 0) return e;
  if ((e = encode<D>(&tm_do, x.dout, sq, h, b, x.do_s, kBM)) != 0) return e;
  if ((e = encode<D>(&tm_k, x.k, skv, hk, b, x.k_s, C::BN)) != 0) return e;
  if ((e = encode<D>(&tm_v, x.v, skv, hk, b, x.v_s, C::BN)) != 0) return e;
  FusedParams p;
  p.b = b;
  p.h = h;
  p.hk = hk;
  p.n_rep = h / hk;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.n_qt = n_qt;
  p.ld = ld;
  p.scale = scale;
  p.dk_sb = x.dk_s[0]; p.dk_ss = x.dk_s[1]; p.dk_sh = x.dk_s[2];
  p.dv_sb = x.dv_s[0]; p.dv_ss = x.dv_s[1]; p.dv_sh = x.dv_s[2];
  const int grid = (skv + C::BN - 1) / C::BN * b * hk;
  kernel<<<grid, kFusedThreads, C::bytes, stream>>>(tm_q, tm_k, tm_v, tm_do, x.work, x.work + rows, dq_acc,
                                                    static_cast<bf16*>(x.dk), static_cast<bf16*>(x.dv), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const PostParams pp{h, sq, n_qt, x.dq_s[0], x.dq_s[1], x.dq_s[2]};
  flash_bwd_post_kernel<D><<<(unsigned)((long long)b * h * n_qt * (D / C::NQ)), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<bf16*>(x.dq), pp);
  return (int)cudaGetLastError();
}

// float32: the preprocess (delta), then the dQ kernel and the dK/dV kernel.
template <int D>
int launch_f32(const Tensors& x, int b, int h, int hk, int sq, int skv, float scale, int causal,
               cudaStream_t stream) {
  int e = launch_pre<float, D>(x, b, h, sq, sq, nullptr, 0, stream);
  if (e != 0) return e;
  BwdParams p{};
  p.h = h;
  p.n_rep = h / hk;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = x.q_s[0]; p.q_ss = x.q_s[1]; p.q_sh = x.q_s[2];
  p.k_sb = x.k_s[0]; p.k_ss = x.k_s[1]; p.k_sh = x.k_s[2];
  p.v_sb = x.v_s[0]; p.v_ss = x.v_s[1]; p.v_sh = x.v_s[2];
  p.do_sb = x.do_s[0]; p.do_ss = x.do_s[1]; p.do_sh = x.do_s[2];
  const float* delta = x.work + (long long)b * h * sq;
  const float* q = static_cast<const float*>(x.q);
  const float* k = static_cast<const float*>(x.k);
  const float* v = static_cast<const float*>(x.v);
  const float* dout = static_cast<const float*>(x.dout);
  static bool dq_done = false, dkv_done = false;
  cudaError_t err = configure(flash_bwd_dq_f32_kernel<D>, F32Cfg<D>::dq_bytes, dq_done);
  if (err == cudaSuccess) err = configure(flash_bwd_dkv_f32_kernel<D>, F32Cfg<D>::dkv_bytes, dkv_done);
  if (err != cudaSuccess) return (int)err;
  if (sq > 0) {
    p.a_sb = x.dq_s[0]; p.a_ss = x.dq_s[1]; p.a_sh = x.dq_s[2];
    flash_bwd_dq_f32_kernel<D><<<dim3((sq + kT - 1) / kT, h, b), kThreads, F32Cfg<D>::dq_bytes, stream>>>(
        q, k, v, dout, x.lse, delta, static_cast<float*>(x.dq), p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (skv > 0) {
    p.a_sb = x.dk_s[0]; p.a_ss = x.dk_s[1]; p.a_sh = x.dk_s[2];
    p.b_sb = x.dv_s[0]; p.b_ss = x.dv_s[1]; p.b_sh = x.dv_s[2];
    flash_bwd_dkv_f32_kernel<D><<<dim3((skv + kT - 1) / kT, hk, b), kThreads, F32Cfg<D>::dkv_bytes, stream>>>(
        q, k, v, dout, x.lse, delta, static_cast<float*>(x.dk), static_cast<float*>(x.dv), p);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <int D>
int launch(int dtype, const Tensors& x, int b, int h, int hk, int sq, int skv, float scale, int causal,
           cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<D>(x, b, h, hk, sq, skv, scale, causal, stream);
  return launch_f32<D>(x, b, h, hk, sq, skv, scale, causal, stream);
}

}  // namespace

extern "C" {

// The attention backward: dq, dk and dv from q, k, v, the forward's out
// and lse, and out's cotangent dout. q, out, dout and dq [b, sq, h, d]; k,
// v, dk and dv [b, skv, hk, d]; each given by its batch, sequence and head
// strides in elements (the head dim contiguous; strides and addresses
// 16-byte aligned). lse is float32 [b, h, sq], contiguous. work is float32
// scratch of 2 * b * h * ld floats (lse2 and delta) plus, for bf16, the dQ
// accumulator of b * h * ld * d floats, where ld is sq rounded up to a
// multiple of 64 for bf16 and sq for float32. sq and skv are at least 1.
// dtype: 0 float32, 1 bf16. Returns 0 on success, the CUDA error code of a
// launch, or hopper::kTensorMapError + the CUresult when a tensor map
// cannot be encoded.
int rt_flash_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 const void* lse, void* work, void* dq, void* dk, void* dv, int dtype,
                 int b, int h, int hk, int sq, int skv, int d,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 long long do_sb, long long do_ss, long long do_sh,
                 long long dq_sb, long long dq_ss, long long dq_sh,
                 long long dk_sb, long long dk_ss, long long dk_sh,
                 long long dv_sb, long long dv_ss, long long dv_sh,
                 float scale, int causal, void* stream) {
  if (hk <= 0 || h % hk != 0 || sq <= 0 || skv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Tensors x{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(work), dq, dk, dv,
                  {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh},
                  {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh}, {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(dtype, x, b, h, hk, sq, skv, scale, causal, s);
    case 128: return launch<128>(dtype, x, b, h, hk, sq, skv, scale, causal, s);
    case 256: return launch<256>(dtype, x, b, h, hk, sq, skv, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
