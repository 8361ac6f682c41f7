// Flash-attention forward for Hopper (sm_90a): K1.
//
// Replaces: ray_tpu/ops/flash_attention.py:_fwd_kernel, the Pallas forward
// that _flash_fwd launches. It computes O = softmax(scale * Q K^T, masked) V
// with an online softmax. The running max m, the denominator l and the
// output accumulator are float32. On request it also writes the per-row
// log-sum-exp lse = m + log(l), float32 [b, h, sq]. The causal mask keeps
// k_pos <= q_pos, aligned at the top left, as the TPU kernel does. A row
// with no visible key gets output 0 and lse -inf. As on the TPU, the
// unnormalized probabilities are rounded to the input type before the P V
// product and l sums the unrounded ones.
//
// What bounds it on an H100: at the Llama-3-8B attention shape (h 32,
// hk 8, d 128, s 2048, causal) the work is about 34 GFLOP of matrix
// products against about 42 MB of compulsory traffic, roughly 800 FLOP per
// byte. The card's ridge is about 295 FLOP per byte in bf16, so the tensor
// cores bound it, and on Hopper only wgmma reaches their full rate. Next in
// line: the softmax (one exp2 per score on the special function unit, and
// about eight other instructions), which must hide behind the products, and
// every fixed cost of a q tile (loading Q, storing O), which must hide
// behind another tile's work.
//
// What the design does about that (bf16; FA3's shape): a persistent block
// of three warpgroups per SM walks q tiles of 128 rows of one (batch, head),
// the heaviest causal tiles first, in an order that evens out the blocks.
// - Warpgroup 0 is the producer. It gives its registers away (setmaxnreg
//   down to 24), and one of its threads issues TMA loads: each q tile's Q
//   (into a buffer with full and empty barriers, so the next tile's Q loads
//   while this one finishes), and the K and V tiles through a ring of
//   stages in shared memory, each with a full barrier armed with its bytes
//   and an empty barrier that the consumers' warps arrive on. K and V have
//   barriers of their own, so Q K^T starts before V lands. The ring runs on
//   across q tiles. Tiles are stored with 128-byte swizzle, a d-128 row as
//   two 64-wide boxes. The tensor maps read the [b, s, h, d] views of the
//   main path through their strides, so GQA reads kv head h / n_rep with no
//   repeat and no copy, and TMA zero-fills rows past the end.
// - Warpgroups 1 and 2 are consumers (setmaxnreg up to 240), 64 q rows
//   each. S = Q K^T is wgmma m64n{BN}k16 with both operands in shared
//   memory, K-major. The online softmax runs on the accumulator fragment in
//   registers (base 2; row max and sum across the four threads of a quad,
//   the sum's reduction deferred to the end; a compare and a select a score
//   mask only the tiles that reach the diagonal or a ragged tail). P is
//   packed to bf16 in registers as the register A operand of wgmma
//   m64n{d}k16; V is the B operand read MN-major from its swizzled tiles.
// - Overlap: within a warpgroup, Q K^T of kv tile j + 1 is issued before
//   P V of tile j, so the softmax of j + 1 runs while P V is on the tensor
//   cores; across the two, named barriers make them take turns to issue
//   their products, so one's softmax runs while the other's products hold
//   the tensor cores (FA3's ping-pong).
// - Epilogue: O / l in bf16 goes to a staging tile in shared memory and
//   out by a TMA store that overlaps the next q tile (d <= 128); lse from
//   registers.
// - Rules of the machinery that the code keeps (each broke it once):
//   nothing between a wgmma and its wait may branch divergently or write
//   the wgmma's registers, or ptxas serializes the products (C7520, C7513);
//   a trap on the consumers' path keeps them within the launch register
//   count despite setmaxnreg (spills, C7512). Hence the predicated barrier
//   arrivals, the asm spin wait, and P packed only after P V completes.
// - d 64: 128-row kv tiles, 3 stages; d 128: 128-row kv tiles, 2 stages
//   (the staging tile takes the third's room); d 256: 48-row kv tiles (the
//   128-float accumulator leaves room for no more) and 3 stages, output
//   stored from registers.
//
// The float32 path is scalar FMA over shared-memory tiles; it exists so
// the kernel can be held to float32 exactness.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 64;          // q rows per block of the float32 path
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBM / kWarps;   // float32 path

struct Params {
  int b, h, n_rep, sq, skv, causal;
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
// bf16: TMA ring, warp-specialised wgmma, register-resident online softmax
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kBf16Threads = 3 * kWgThreads;     // producer + two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// 65,536 registers over 384 threads: ptxas gives each thread 168 at
// launch, which setmaxnreg moves from the producer to the consumers
// (2 * 128 * 240 + 128 * 24 = 168 * 384). Fewer at launch and the
// consumers' setmaxnreg.inc would wait forever.
constexpr int kLaunchRegs = (2 * kConsumerRegs + kProducerRegs) / 3;
constexpr int kConsumerWarps = 8;               // arrivals that free a stage

// Shared memory, at most 227 KB: Q, the K and V rings, and (d <= 128) the
// output tile staged for a TMA store. d 64: 16 + 3 x 32 + 16 KB; d 128:
// 32 + 2 x 64 + 32 KB; d 256 (48-row kv tiles, which keep the consumers
// within 240 registers; output stored from registers): 64 + 3 x 48 KB.
template <int D>
struct TmaCfg {
  static constexpr int BM = 128;                     // q rows: 64 per consumer warpgroup
  static constexpr int BN = D <= 128 ? 128 : 48;     // kv rows per stage
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr bool kStoreO = D <= 128;          // epilogue through shared memory and TMA
  static constexpr int kBoxes = D / 64;              // 64-column swizzled boxes per row
  static constexpr uint32_t q_bytes = BM * D * 2;
  static constexpr uint32_t kv_bytes = BN * D * 2;   // one K or V stage
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int o_off = v_off + kStages * kv_bytes;
  static constexpr int bar_off = o_off + (kStoreO ? q_bytes : 0);
  static constexpr int n_bars = 2 + 4 * kStages;     // Q, K and V full and empty
  static constexpr int bytes = bar_off + n_bars * 8 + 1024;   // + slack to align to 1024
};

// S = Q K^T for one consumer warpgroup's 64 rows: d / 16 k16 steps, both
// operands K-major in shared memory. Issued, not waited for.
template <int D, int BM, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], const bf16* qw, const bf16* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // box kk / 4; a k16 step inside the 128-byte row moves 32 bytes
    const int col = (kk % 4) * 16;
    const uint64_t da = hopper::desc_sw128(qw + (kk / 4) * BM * 64 + col, 16, 1024);
    const uint64_t db = hopper::desc_sw128(ks + (kk / 4) * BN * 64 + col, 16, 1024);
    hopper::Wgmma<BN>::template ss<0, 0>(s, da, db, kk > 0 ? 1 : 0);
  }
}

// O += P V: P the register A operand, V read MN-major (d contiguous; LBO
// steps from one 64-column box to the next), one k16 step per 16 kv rows.
// Issued, not waited for.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                         const bf16* vs) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) {
    const uint64_t db = hopper::desc_sw128(vs + c * 16 * 64, BN * 128, 1024);
    hopper::Wgmma<D>::template rs<1>(acc, pa[c], db, 1);
  }
}

// One online-softmax step on a score tile in the wgmma accumulator layout
// (this thread: rows row0 and row0 + 8, columns kv0 + 8 i + 2 t, + 1):
// scale to base 2, hide the columns at or past lim[r] (the row's first
// hidden key: the end of kv, or row + 1 under the causal mask), turn the
// scores into unnormalized probabilities in place, update the running max
// m and this thread's share of l, and return the factor corr that rescales
// the output. Straight-line code (it runs while P V is in flight, where a
// branch would serialize the products: C7520); kMask adds the mask as a
// compare and a select a score.
template <int BN, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int (&lim)[2], int kv0, int t,
                                             float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = s[4 * i + e] * scale2;
      if (kMask) x = (8 * i + 2 * t + (e & 1) < lim[r] - kv0) ? x : -INFINITY;
      s[4 * i + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row's values sit in the 4 threads of its quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    // a row with no visible key so far keeps p = 0 instead of exp(nan)
    base[r] = (mn == -INFINITY) ? 0.0f : mn;
    corr[r] = exp2_approx(m[r] - base[r]);
    m[r] = mn;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(s[i] - base[r]);
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// P rounded to bf16 as the register A operand of P V: the probability
// fragments of two adjacent 8-column tiles make one k16 step. Written only
// once the previous P V is complete: a write to a wgmma's input register
// while it runs serializes the products (C7513).
template <int BN>
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) {
    pa[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
    pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
    pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
    pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
  }
}

// The work of the persistent kernel: one tile is the BM q rows at q0 of
// one (batch, head). Tiles are ranked heaviest first (the last causal q
// tiles, of every batch and head), and CTA c of G takes the tiles of its
// rounds r = 0, 1, ... snaking through the ranking: r G + c on even rounds,
// r G + G - 1 - c on odd ones, so every CTA's heavy and light tiles even out.
struct Tile {
  int q0, h, b, n_kt;
};

__device__ __forceinline__ int tile_index(int r) {
  const int g = (int)gridDim.x, c = (int)blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - c : c);
}

template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(int i, const Params& p) {
  const int n_qt = (p.sq + BM - 1) / BM;
  const int n_bh = p.b * p.h;
  Tile tl;
  tl.q0 = (n_qt - 1 - i / n_bh) * BM;
  tl.h = i % n_bh % p.h;
  tl.b = i % n_bh / p.h;
  tl.n_kt = (p.skv + BN - 1) / BN;
  if (p.causal) tl.n_kt = min(tl.n_kt, (tl.q0 + BM - 1) / BN + 1);
  return tl;
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                      bf16* __restrict__ o, float* __restrict__ lse, const Params p) {
  using C = TmaCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: every box starts on that
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sQ = reinterpret_cast<bf16*>(smem);               // [kBoxes][BM][64]
  bf16* sK = reinterpret_cast<bf16*>(smem + C::k_off);    // [S][kBoxes][BN][64]
  bf16* sV = reinterpret_cast<bf16*>(smem + C::v_off);    // [S][kBoxes][BN][64]
  bf16* sO = reinterpret_cast<bf16*>(smem + C::o_off);    // [kBoxes][BM][64] (kStoreO)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + S;
  uint64_t* v_full = k_empty + S;
  uint64_t* v_empty = v_full + S;
  uint64_t* q_empty = v_empty + S;
  const int n_tiles = (p.sq + BM - 1) / BM * p.b * p.h;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(k_empty + s, kConsumerWarps);
      hopper::mbar_init(v_empty + s, kConsumerWarps);
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
      int pos = 0;   // K/V tiles loaded so far: the ring position, across q tiles
      for (int r = 0;; ++r) {
        const int i = tile_index(r);
        if (i >= n_tiles) break;
        const Tile tl = tile_at<BM, BN>(i, p);
        const int hk = tl.h / p.n_rep;
        hopper::mbar_wait(q_empty, (r & 1) ^ 1);   // the previous tile's Q is no longer read
        hopper::mbar_arrive_expect_tx(q_full, C::q_bytes);
#pragma unroll
        for (int j = 0; j < C::kBoxes; ++j)
          hopper::tma_load_4d(sQ + j * BM * 64, &tm_q, q_full, j * 64, tl.q0, tl.h, tl.b);
        for (int kt = 0; kt < tl.n_kt; ++kt, ++pos) {
          const int st = pos % S;
          const uint32_t ph = (pos / S) & 1;
          bf16* dk = sK + st * BN * D;
          bf16* dv = sV + st * BN * D;
          hopper::mbar_wait(k_empty + st, ph ^ 1);   // the consumers are done with the stage
          hopper::mbar_arrive_expect_tx(k_full + st, C::kv_bytes);
#pragma unroll
          for (int j = 0; j < C::kBoxes; ++j)
            hopper::tma_load_4d(dk + j * BN * 64, &tm_k, k_full + st, j * 64, kt * BN, hk, tl.b);
          hopper::mbar_wait(v_empty + st, ph ^ 1);
          hopper::mbar_arrive_expect_tx(v_full + st, C::kv_bytes);
#pragma unroll
          for (int j = 0; j < C::kBoxes; ++j)
            hopper::tma_load_4d(dv + j * BN * 64, &tm_v, v_full + st, j * 64, kt * BN, hk, tl.b);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    constexpr int NO = D / 2;     // output floats a thread
    const int w = threadIdx.x / kWgThreads - 1;   // q rows 64 w .. 64 w + 63 of a tile
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const bf16* qw = sQ + 64 * w * 64;            // the warpgroup's rows in box 0
    // scores go to base 2: exp2 is one instruction, and p is unchanged
    const float scale2 = p.scale * 1.4426950408889634f;
    float acc[NO];
    float m[2], l[2];   // l: this thread's share, summed over the quad at the end
    float s[BN / 2];
    uint32_t pa[BN / 16][4];   // P of the tile whose P V comes next
    float corr[2];
    int lim[2];                // each row's first hidden key

    // The two consumer warpgroups take turns to issue their products
    // (named barrier 1 + w is warpgroup w's turn), so one's softmax runs
    // while the other's products hold the tensor cores. Warpgroup 1 hands
    // the first turn to warpgroup 0.
    auto take_turn = [&] { hopper::named_bar_sync(1 + w, 2 * kWgThreads); };
    auto pass_turn = [&] { hopper::named_bar_arrive(2 - w, 2 * kWgThreads); };
    if (w == 1) pass_turn();

    // Within a warpgroup the products are pipelined by one kv tile: Q K^T
    // of tile kt (ring position pos) is issued before P V of tile kt - 1, so
    // the softmax of tile kt runs while P V is on the tensor cores. `last`:
    // this Q K^T is the q tile's last read of Q.
    auto step = [&](int pos, int kv0, bool last, auto mask) {
      const int st = pos % S, pst = (pos - 1) % S;
      // both waits before the first product: between a product and its
      // wait sit only products, the softmax and predicated arrivals
      hopper::mbar_wait(v_full + pst, ((pos - 1) / S) & 1);
      hopper::mbar_wait(k_full + st, (pos / S) & 1);
      take_turn();
      hopper::wgmma_fence();
      issue_qk<D, BM, BN>(s, qw, sK + st * BN * D);
      hopper::wgmma_commit();
      issue_pv<D, BN>(acc, pa, sV + pst * BN * D);
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<1>();   // Q K^T done; P V may still run
      hopper::fence_operand(s);
      hopper::mbar_arrive_if(k_empty + st, lane == 0);
      hopper::mbar_arrive_if(q_empty, lane == 0 && last);
      softmax_tile<BN, decltype(mask)::value>(s, m, l, corr, lim, kv0, t, scale2);
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      hopper::mbar_arrive_if(v_empty + pst, lane == 0);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];
      pack_p<BN>(s, pa);
    };

    int pos = 0;   // ring position of the q tile's first kv tile
    for (int r = 0;; ++r) {
      const int i = tile_index(r);
      if (i >= n_tiles) break;
      const Tile tl = tile_at<BM, BN>(i, p);
      const int n_kt = tl.n_kt;
      const int row0 = tl.q0 + 64 * w + 16 * warp + lane / 4;   // this thread's rows: row0, + 8
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        lim[r2] = p.causal ? min(p.skv, row0 + 8 * r2 + 1) : p.skv;
        m[r2] = -INFINITY;
        l[r2] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < NO; ++k) acc[k] = 0.0f;
      // the leading kv tiles that hide no key of this warpgroup's rows
      int n_open = p.skv / BN;
      if (p.causal) n_open = min(n_open, (tl.q0 + 64 * w + 1) / BN);
      n_open = min(n_open, n_kt);

      hopper::mbar_wait(q_full, r & 1);
      if (n_kt > 0) {
        const int st = pos % S;
        hopper::mbar_wait(k_full + st, (pos / S) & 1);
        take_turn();
        hopper::wgmma_fence();
        issue_qk<D, BM, BN>(s, qw, sK + st * BN * D);
        hopper::wgmma_commit();
        pass_turn();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(s);
        hopper::mbar_arrive_if(k_empty + st, lane == 0);
        hopper::mbar_arrive_if(q_empty, lane == 0 && n_kt == 1);
        // acc is still 0: no rescale
        if (n_open > 0)
          softmax_tile<BN, false>(s, m, l, corr, lim, 0, t, scale2);
        else
          softmax_tile<BN, true>(s, m, l, corr, lim, 0, t, scale2);
        pack_p<BN>(s, pa);
      } else {
        hopper::mbar_arrive_if(q_empty, lane == 0);
      }
      for (int kt = 1; kt < n_open; ++kt) step(pos + kt, kt * BN, kt == n_kt - 1, std::false_type{});
      for (int kt = max(n_open, 1); kt < n_kt; ++kt)
        step(pos + kt, kt * BN, kt == n_kt - 1, std::true_type{});
      if (n_kt > 0) {
        const int st = (pos + n_kt - 1) % S;
        hopper::mbar_wait(v_full + st, ((pos + n_kt - 1) / S) & 1);
        hopper::wgmma_fence();
        issue_pv<D, BN>(acc, pa, sV + st * BN * D);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(acc);
        hopper::mbar_arrive_if(v_empty + st, lane == 0);
      }
      pos += n_kt;

      // out = acc / l; lse = m + log(l), with m back in natural-log units
      constexpr float kLn2 = 0.6931471805599453f;
      float inv[2];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 1);
        l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 2);
        const float ls = (l[r2] == 0.0f) ? 1.0f : l[r2];
        inv[r2] = 1.0f / ls;   // one division a row, not one an element
        const int row = row0 + 8 * r2;
        if (lse != nullptr && t == 0 && row < p.sq)
          lse[((long long)tl.b * p.h + tl.h) * p.sq + row] =
              (l[r2] == 0.0f) ? -INFINITY : m[r2] * kLn2 + logf(ls);
      }
      if constexpr (C::kStoreO) {
        // The warpgroup's 64 rows go to the staging tile in the swizzled
        // layout (16-byte chunk c of row r at chunk c ^ (r % 8): the stores
        // of a warp hit 32 distinct banks), then one thread stores them with
        // TMA, which drops rows past the end; the store overlaps the next
        // tile. Its previous store must have read the rows first.
        const bool leader = threadIdx.x % kWgThreads == 0;
        if (leader) hopper::tma_store_wait_read();
        hopper::named_bar_sync(3 + w, kWgThreads);
        unsigned char* so = reinterpret_cast<unsigned char*>(sO + 64 * w * 64);
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int rr = 16 * warp + lane / 4 + 8 * r2;   // row within the warpgroup's 64
#pragma unroll
          for (int k = 0; k < D / 8; ++k) {
            const int box = k / 8, chunk = k % 8;
            *reinterpret_cast<__nv_bfloat162*>(so + box * BM * 128 + rr * 128 + ((chunk ^ (rr % 8)) * 16) +
                                               4 * t) =
                __floats2bfloat162_rn(acc[4 * k + 2 * r2] * inv[r2], acc[4 * k + 2 * r2 + 1] * inv[r2]);
          }
        }
        hopper::fence_proxy_async();
        hopper::named_bar_sync(3 + w, kWgThreads);
        if (leader) {
#pragma unroll
          for (int j = 0; j < C::kBoxes; ++j)
            hopper::tma_store_4d(&tm_o, so + j * BM * 128, j * 64, tl.q0 + 64 * w, tl.h, tl.b);
          hopper::tma_store_commit();
        }
      } else {
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int row = row0 + 8 * r2;
          if (row >= p.sq) continue;
          bf16* orow = o + tl.b * p.o_sb + tl.h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
          for (int k = 0; k < D / 8; ++k)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * k + 2 * t) =
                __floats2bfloat162_rn(acc[4 * k + 2 * r2] * inv[r2], acc[4 * k + 2 * r2 + 1] * inv[r2]);
        }
      }
    }
    // the last TMA stores are complete before the CTA (and its shared
    // memory) goes
    if (C::kStoreO && threadIdx.x % kWgThreads == 0) hopper::tma_store_wait_all();
    // warpgroup 1 passed one turn more than warpgroup 0 took
    if (w == 0) take_turn();
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

// The bf16 kernel: tensor maps over q, k and v (4-D: d, s, heads, batch,
// from the element strides), then the launch. Returns 0, a CUDA error, or
// hopper::kTensorMapError + the CUresult of a failed encode.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b, int hk,
                const Params& p, cudaStream_t stream) {
  using C = TmaCfg<D>;
  auto kernel = flash_fwd_bf16_kernel<D>;
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

  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const uint64_t q_dims[4] = {(uint64_t)D, (uint64_t)p.sq, (uint64_t)p.h, (uint64_t)b};
  const uint64_t q_str[3] = {2ull * p.q_ss, 2ull * p.q_sh, 2ull * p.q_sb};
  int e = hopper::encode_bf16_sw128(&tm_q, q, q_dims, q_str, C::BM);
  if (e != 0) return e;
  if (p.skv > 0) {
    const uint64_t kv_dims[4] = {(uint64_t)D, (uint64_t)p.skv, (uint64_t)hk, (uint64_t)b};
    const uint64_t k_str[3] = {2ull * p.k_ss, 2ull * p.k_sh, 2ull * p.k_sb};
    const uint64_t v_str[3] = {2ull * p.v_ss, 2ull * p.v_sh, 2ull * p.v_sb};
    e = hopper::encode_bf16_sw128(&tm_k, k, kv_dims, k_str, C::BN);
    if (e != 0) return e;
    e = hopper::encode_bf16_sw128(&tm_v, v, kv_dims, v_str, C::BN);
    if (e != 0) return e;
  } else {
    tm_k = tm_v = tm_q;   // no kv tile: never read
  }
  if (C::kStoreO) {
    const uint64_t o_str[3] = {2ull * p.o_ss, 2ull * p.o_sh, 2ull * p.o_sb};
    e = hopper::encode_bf16_sw128(&tm_o, o, q_dims, o_str, 64);
    if (e != 0) return e;
  } else {
    tm_o = tm_q;   // the output is stored from registers: never used
  }
  // persistent: one CTA per SM, or one per tile when there are fewer
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (p.sq + C::BM - 1) / C::BM * p.h * b;
  const int grid = n_tiles < sms ? n_tiles : sms;
  if (grid == 0) return 0;
  kernel<<<grid, kBf16Threads, C::bytes, stream>>>(tm_q, tm_k, tm_v, tm_o, static_cast<bf16*>(o), lse, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse, int b, int hk,
           const Params& p, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, lse, b, hk, p, stream);
  static bool done = false;
  cudaError_t err = configure(flash_fwd_f32_kernel<D>, F32Smem<D>::bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.sq + kBM - 1) / kBM, p.h, b);
  flash_fwd_f32_kernel<D><<<grid, kThreads, F32Smem<D>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [b, sq, h, d], k and v [b, skv, hk, d], o like q, each given by its
// batch, sequence and head strides in elements (the head dim is
// contiguous; bf16 strides and addresses 16-byte aligned). lse is float32
// [b, h, sq], or null. Returns 0 on success, the CUDA error code of the
// launch, or hopper::kTensorMapError + the CUresult when a
// tensor map cannot be encoded.
int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                 int b, int h, int hk, int sq, int skv, int d,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale, int causal, void* stream) {
  if (hk <= 0 || h % hk != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Params p;
  p.b = b;
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
    case 64: return launch<64>(dtype, q, k, v, o, l, b, hk, p, s);
    case 128: return launch<128>(dtype, q, k, v, o, l, b, hk, p, s);
    case 256: return launch<256>(dtype, q, k, v, o, l, b, hk, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
