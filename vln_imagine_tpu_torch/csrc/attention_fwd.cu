// Fused multi-head attention forward for Hopper (sm_90a), with and without
// attention-probs dropout.
//
// Replaces vln_imagine_tpu/ops/attention.py:_fwd_kernel (K1, the Pallas TPU
// kernel reached through _pallas_attention_fwd) and _fwd_dropout_kernel (K2,
// through _pallas_attention_dropout_fwd).  For every (batch, head):
//
//     O = (softmax(Q K^T * scale + bias) * M) V
//
// in the same order as the TPU kernels: f32 scores, + bias, exact row max
// and row sum, P = exp(S - max) / sum normalised before it is rounded, P
// times the dropout mask M (K2 only; dropout_bits.cuh), P rounded to V's
// dtype, P V accumulated in f32, O in Q's dtype.  P is never left
// unnormalised and rescaled later (FlashAttention's form), so the kernel
// rounds the same P as the plain version at every Lk up to 1024.  K2 draws
// its mask from a counter-based generator in place of the TPU's per-core
// PRNG, so the backward kernel (attention_bwd.cu) regenerates it from the
// seed and no [Lq, Lk] mask ever reaches device memory.
//
// Layout.  Q, K, V and O are [B, L, H, D] (the projection layout of the
// model's packed QKV product), so no head transposes surround the kernel.
// Q/K/V arrive as strided views (row stride 3*H*D when they are slices of
// the packed product); the last dim is contiguous and every row starts on
// 16 bytes (the wrapper checks both), so tiles are copied into shared memory
// with 16-byte cp.async.  The additive bias is f32 [B, 1|H, 1|Lq, Lk] read
// through its strides: the [B,1,1,Lk] padding mask has stride 0 over heads
// and query rows, and a block stages its one row once.
//
// What bounds it.  At the model's shapes (L <= 80, H 12, D 64) the work is
// two [L, L, D] products per (batch, head), about 4*L*D flops per 4*L*D
// bytes of Q/K/V/O: far below the ~295 flop/byte at which an H100's tensor
// cores, not its memory, become the limit, so by the roofline the kernel is
// bound by bytes.  In practice it is bound by instruction issue and latency:
// a (16 rows, head) tile is a few dozen tensor-core instructions beside a few
// hundred for the softmax, the staging and the merges, so what counts is how
// few instructions each element of S costs, how many warps run at once and
// how long each one's chain of dependent steps is.
//
// Design (the skeleton of attention_bwd.cu's dq kernel).  One block of
// kWarps warps per (16 query rows, head, batch item): 480 blocks at B 8 and
// 3,840 at B 64 for L 80.  The keys are staged at most 128 (64 at D 128) at
// a time; the warps take the chunk's 16-key sub-tiles in turn.
//   Sweep 0: S = Q K^T * scale + bias on the tensor cores, each warp's
//   online row max and sum of exp(S - max), merged across the warps in warp
//   order into the exact max and sum of every row.
//   Sweep 1: each warp turns its sub-tiles of S into
//   P = exp(S - max) * (1 / sum) (one rounded reciprocal a row: a division
//   an element was the costliest single step on an H100), times the keep
//   mask for K2, rounded to V's dtype into a [16, keys] tile of P in shared
//   memory; then each warp takes a quarter of O's columns (16 at least: two
//   warps at D 32) and adds P V over all the chunk's keys.
// So no partial O is merged across warps, the P V work is even across warps
// however the keys fall, and each output element is written once, from
// registers: no atomics, and two calls give the same bits.  When all keys
// fit one staged chunk (every shape of the main path), sweep 0 keeps S in
// registers for sweep 1 and V's copy overlaps sweep 0; past one chunk,
// sweep 1 stages K and V again and recomputes S with the same instructions,
// so both sweeps see the same bits.  Shared memory per block is bounded by
// the tiles, not by L; a static_assert in launch() holds the largest (a full
// chunk) under the card's 227 KB.  A register budget for six blocks (24
// warps) an SM at bf16 D <= 64 serves the B 64 eval calls.  On an H100, a
// warp per 16 query rows walking every key (no merges, K and V staged once
// per block) was slower than the key split at every eval and training shape:
// it needs far more registers a thread and five sub-tiles a warp in place of
// two.
//
// Padded keys.  Where the bias is one key row an item (f32, stride 0 over
// heads and query rows: the [B,1,1,Lk] padding mask) and the keys take more
// than one staged chunk, a block sweeps only its item's live 16-key sub-tiles,
// those with a key above the padding value -10000 (ops/masks.py:NEG_INF_MASK)
// (attention_fwd_kernel<T, D, true>).  Each warp reads the row itself and
// lists the live sub-tiles in order, so no block-wide barrier comes before the
// first chunk's copies; their K, V and bias are staged packed, one strided
// copy a run of consecutive sub-tiles, in as few chunks as they need.  DUET's
// text of some 33 of 200 slots then takes one chunk in place of two, with S
// kept in registers and V's copy overlapped.  For an item with a valid key a
// padded key's exp(S - max) is exactly 0 in f32 (S lies some 10,000 below the
// max), so the sub-tiles left out add nothing to any row's sum or to P V;
// dealing the live sub-tiles to other warps reorders the row sums by an ulp at
// most.  Every key keeps its own index for the -inf past Lk and for K2's
// dropout bits.  An item with no valid key, or with every sub-tile live,
// sweeps them all.  Keys that fit one chunk, no bias, and a per-head or
// per-row bias take the sweep over every sub-tile (attention_fwd_kernel<T, D,
// false>): on an H100, finding the live sub-tiles of a one-chunk row cost more
// than they saved at every eval shape.  A non-null counter buffer gets each
// block's swept and total sub-tiles (the wrapper passes one only while spans
// are on).
//
// Products (attention_tiles.cuh).  bf16: mma.sync.m16n8k16 (bf16 in, f32
// accumulate), Q, K and P through ldmatrix, V through ldmatrix.trans, from
// rows padded by 16 bytes.  f32: the same tiles and fragment layout with
// CUDA-core FMAs (no TF32).  exp is the fast __expf (ex2.approx: about
// 1e-6 relative error where exp(S - max) is not negligible, far inside the
// 1e-4 tolerance of the f32 outputs; faster at B 64).
//
// Measured (chip_smoke.py --parent: CUDA-graph replays, inputs warm in L2;
// NVIDIA H100 80GB HBM3, power limit 700 W; bf16, H 12, D 64, [B,1,1,Lk]
// mask).  K1 at the six eval shapes: 0.0155 to 0.0342 ms at B 64 (SDPA
// 0.0251 to 0.0455; the CUDA-core kernel this replaces 0.0483 to 0.1327),
// 0.0052 to 0.0077 ms at B 8 (SDPA 0.0079 to 0.0119).  K2 with Philox bits
// at the eight training shapes, B 8: 0.0067 to 0.0098 ms (SDPA with dropout
// 0.0121 to 0.0163; before 0.0143 to 0.0256).  The byte bound is 0.0042 to
// 0.0094 ms at B 64 and 0.0005 to 0.0012 ms at B 8.  K1 over DUET's key rows
// with R2R-sized texts and imaginations at B 512: 97/220 0.418 ms, 51/220
// 0.244, 200/200 0.677 (the sweep over every sub-tile: 0.949, 0.545, 1.667;
// SDPA 0.265, 0.257, 0.506); with every key valid at 97/220, 1.043 against
// 0.949.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

namespace {

using namespace vln;

// a key whose bias is at or below this is padding (ops/masks.py)
constexpr float kNegInfMask = -10000.f;
// key sub-tiles of the longest Lk the kernel takes (ops/attention.py:MAX_LK)
constexpr int kMaxTiles = 64;
// slots of the sub-tile counters, so that the blocks' atomics spread
constexpr int kCountSlots = 64;
// shared memory the packed sweep adds: each warp's copy of the live
// sub-tiles (a byte each)
constexpr size_t kPackSmem = kWarps * kMaxTiles;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // nullptr: no bias
  void* o;
  int B, H, Lq, Lk;
  int kc;             // keys staged at a time
  int brows;          // bias rows staged: 1 when they are all one row
  long long sqb, sql, sqh;
  long long skb, skl, skh;
  long long svb, svl, svh;
  long long sbb, sbh, sbq, sbk;
  float scale;
  vln::DropoutParams drop;  // drop.bits == kBitsNone: K1
  unsigned long long* counts;  // nullptr, or [kCountSlots][swept, total]
};

// blocks per SM the register budget must allow: six at bf16 D <= 64 (at
// most 85 registers a thread), so that B 64 eval calls keep 24 warps an SM;
// five for the packed sweep, whose full chunk of keys fits five blocks an SM
template <typename T, int D, bool kPack>
constexpr int min_blocks() {
  return std::is_same<T, float>::value || D > 64 ? 2 : kPack ? 5 : 6;
}

// key sub-tiles a warp takes in one staged chunk, at most
template <int D>
__host__ __device__ constexpr int subs_per_warp() { return chunk_rows(D) / (kSub * kWarps); }

// Shared memory of a block: Q [kRows, LD]; K and V [kc, LD]; each warp's
// row max and sum (f32 [2, kWarps, kRows]); the bias of the staged keys (f32
// [brows, kc]); P of the staged keys in V's dtype ([kRows, kc + pad]).
template <typename T, int D>
__host__ __device__ constexpr size_t fwd_smem(int kc, int brows) {
  return static_cast<size_t>(kRows) * (D + pad<T>()) * sizeof(T) +
         2 * static_cast<size_t>(kc) * (D + pad<T>()) * sizeof(T) +
         2 * static_cast<size_t>(kWarps) * kRows * sizeof(float) +
         static_cast<size_t>(brows) * kc * sizeof(float) +
         static_cast<size_t>(kRows) * (kc + pad<T>()) * sizeof(T);
}

// warps that take a column slice of O in sweep 1 (16 columns at least)
template <int D>
__host__ __device__ constexpr int col_warps() { return D / 16 < kWarps ? D / 16 : kWarps; }

// the key sub-tiles tiles[0, n) of a strided [L, D] slice, packed in order
// into a [n * kSub, D + pad] tile, one strided copy a run of consecutive
// sub-tiles; rows >= L are zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage_tiles(T* dst, const T* src, long long row_stride,
                                            const unsigned char* tiles, int n, int L) {
  constexpr int LD = D + pad<T>();
  int u = 0;
  while (u < n) {
    int e = u + 1;
    while (e < n && tiles[e] == tiles[e - 1] + 1) ++e;
    stage<T, D>(dst + u * kSub * LD, src, row_stride, tiles[u] * kSub, L, (e - u) * kSub);
    u = e;
  }
}

// kPack: the bias is one key row an item and the keys take more than one
// staged chunk; the block sweeps its item's live sub-tiles, packed
template <typename T, int D, bool kPack>
__global__ void __launch_bounds__(kThreads, min_blocks<T, D, kPack>())
    attention_fwd_kernel(const Params p) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int LD = D + pad<T>();
  constexpr int NC = D / col_warps<D>();
  constexpr int kSubs = subs_per_warp<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = p.kc;
  T* qs = reinterpret_cast<T*>(smem);          // [kRows][LD]
  T* ks = qs + kRows * LD;                     // [kc][LD]
  T* vs = ks + kc * LD;                        // [kc][LD]
  float* stat = reinterpret_cast<float*>(vs + kc * LD);  // [2][kWarps][kRows]
  float* bs = stat + 2 * kWarps * kRows;                 // [brows][kc]
  T* ps = reinterpret_cast<T*>(bs + p.brows * kc);       // [kRows][LDP]
  const int LDP = kc + pad<T>();

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Lq = p.Lq, Lk = p.Lk;
  const bool dropout = p.drop.bits != vln::kBitsNone;
  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const float* bias = p.bias == nullptr ? nullptr : p.bias + b * p.sbb + h * p.sbh;
  const int bld = p.brows == 1 ? 0 : kc;  // row stride of the staged bias
  const int ntiles = (Lk + kSub - 1) / kSub;

  stage<T, D>(qs, qg, p.sql, row0, Lq, kRows);

  int nkeys = Lk;       // the keys the chunks stage, in all
  int swept = ntiles;   // the sub-tiles the block sweeps
  bool packed = false;  // the live sub-tiles, packed
  // kPack: this warp's copy of the live sub-tiles, in order
  unsigned char* tiles = reinterpret_cast<unsigned char*>(ps + kRows * LDP) + warp * kMaxTiles;
  if constexpr (kPack) {
    // every warp alike: bit t of m says whether sub-tile t holds a valid key
    // (a ballot covers two)
    unsigned long long m = 0;
    for (int base = 0; base < Lk; base += 8 * 32) {
      bool valid[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // every load before the first ballot
        const int j = base + 32 * k + lane;
        valid[k] = j < Lk && __ldg(bias + j * p.sbk) > kNegInfMask;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned w = __ballot_sync(0xffffffffu, valid[k]);
        const int t0 = (base + 32 * k) / kSub;  // at most 62: Lk <= 1024
        m |= static_cast<unsigned long long>((w & 0xffffu) != 0u) << t0;
        m |= static_cast<unsigned long long>((w >> kSub) != 0u) << (t0 + 1);
      }
    }
    // an item with no valid key, or none padded, sweeps every sub-tile
    const int n = __popcll(m);
    if (n > 0 && n < ntiles) {
      const unsigned m0 = static_cast<unsigned>(m), m1 = static_cast<unsigned>(m >> 32);
      const unsigned below = (1u << lane) - 1u;
      if ((m0 >> lane) & 1u) tiles[__popc(m0 & below)] = lane;
      if ((m1 >> lane) & 1u) tiles[__popc(m0) + __popc(m1 & below)] = lane + 32;
      __syncwarp();
      swept = n;
      nkeys = n * kSub;
      packed = true;
    }
  }

  const int rows[2] = {row0 + g, row0 + g + 8};
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
  float o[NC / 8][4] = {};
  float sk[kSubs][kNT][4];  // sweep 0's S, kept for sweep 1 in one chunk
  const int nchunks = (nkeys + kc - 1) / kc;
  const bool keep_s = nchunks == 1;

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kc, nk = min(kc, nkeys - c0);
      const unsigned char* ct = tiles + c0 / kSub;  // kPack: the chunk's sub-tiles
      if (sweep == 0 || !keep_s) {
        __syncthreads();  // every warp is done with the previous chunk
        if (packed)
          stage_tiles<T, D>(ks, kg, p.skl, ct, nk / kSub, Lk);
        else
          stage<T, D>(ks, kg, p.skl, c0, Lk, round_up(nk, kSub));
        for (int x = threadIdx.x; x < p.brows * kc; x += kThreads) {
          const int i = row0 + x / kc, jj = x % kc;
          int j = c0 + jj;
          if (packed) j = jj < nk ? ct[jj / kSub] * kSub + jj % kSub : Lk;
          const bool valid = bias != nullptr && i < Lq && j < Lk;
          cp_async4(bs + x, valid ? bias + i * p.sbq + j * p.sbk : p.q, valid);
        }
        if (keep_s) {
          // V's copy overlaps sweep 0; it is waited for before the merge
          cp_async_commit();
          if (packed)
            stage_tiles<T, D>(vs, vg, p.svl, ct, nk / kSub, Lk);
          else
            stage<T, D>(vs, vg, p.svl, c0, Lk, round_up(nk, kSub));
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          if (sweep == 1) {
            if (packed)
              stage_tiles<T, D>(vs, vg, p.svl, ct, nk / kSub, Lk);
            else
              stage<T, D>(vs, vg, p.svl, c0, Lk, round_up(nk, kSub));
          }
          cp_async_wait_all();
        }
        __syncthreads();
      }
      // the warps take the chunk's key sub-tiles in turn, the same ones in
      // both sweeps
#pragma unroll
      for (int u = 0; u < kSubs; ++u) {
        const int s0 = (warp + u * kWarps) * kSub;
        if (s0 >= nk) break;
        int j0 = c0 + s0;  // the sub-tile's first key
        if (packed) j0 = ct[s0 / kSub] * kSub;
        float s[kNT][4];
        if (sweep == 1 && keep_s) {
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = sk[u][n][e];
        } else {
          // S = Q K^T * scale + bias, -inf past Lk
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
          gemm_nt<T, D, kNT>(s, qs, LD, ks + s0 * LD, LD);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int col = s0 + 8 * n + 2 * t, j = j0 + 8 * n + 2 * t;
              const float2 bv = *reinterpret_cast<const float2*>(bs + (g + 8 * r) * bld + col);
              s[n][2 * r] = j < Lk ? s[n][2 * r] * p.scale + bv.x : -INFINITY;
              s[n][2 * r + 1] = j + 1 < Lk ? s[n][2 * r + 1] * p.scale + bv.y : -INFINITY;
            }
          }
          if (sweep == 0 && keep_s) {
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sk[u][n][e] = s[n][e];
          }
        }
        if (sweep == 0) {
          // online row max and sum of exp(S - max)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float m = mx[r];
#pragma unroll
            for (int n = 0; n < kNT; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
            m = quad_max(m);
            sum[r] *= __expf(mx[r] - m);
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) sum[r] += __expf(s[n][e] - m);
            mx[r] = m;
          }
        } else {
          // P = exp(S - max) / sum, times the keep mask, into the P tile
          // rounded to T
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, j = j0 + 8 * n + 2 * t + (e & 1);
              float pv = __expf(s[n][e] - mx[r]) * inv[r];
              if (dropout && rows[r] < Lq && j < Lk)
                pv *= vln::dropout_mask(p.drop, b, h, rows[r], j);
              s[n][e] = pv;
            }
          }
          store_acc<T, kNT>(ps + s0, LDP, s);
        }
      }
      if (sweep == 1) {
        // O[:, slice] += P V[:, slice] over the chunk's keys
        __syncthreads();
        if (warp < col_warps<D>()) {
          for (int k0 = 0; k0 < nk; k0 += kSub)
            gemm_nn<T, kSub, NC / 8>(o, ps + k0, LDP, vs + k0 * LD + warp * NC, LD);
        }
      }
    }
    if (sweep == 0) {
      // merge the warps' statistics, in warp order: every warp gets the
      // same max and sum of each row
      cp_async_wait_all();  // V, when its copy overlapped sweep 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(sum[r]);
        if (t == 0) {
          stat[warp * kRows + g + 8 * r] = mx[r];
          stat[(kWarps + warp) * kRows + g + 8 * r] = l;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        float m = -INFINITY, l = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, stat[w * kRows + row]);
#pragma unroll
        for (int w = 0; w < kWarps; ++w)  // 0 for a warp with no keys
          l = fmaf(stat[(kWarps + w) * kRows + row], __expf(stat[w * kRows + row] - m), l);
        mx[r] = m;
        inv[r] = 1.f / l;
      }
    }
  }

  if (p.counts != nullptr && threadIdx.x == 0) {
    unsigned long long* slot =
        p.counts +
        2 * ((blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % kCountSlots);
    atomicAdd(slot, static_cast<unsigned long long>(swept));
    atomicAdd(slot + 1, static_cast<unsigned long long>(ntiles));
  }

  if (warp < col_warps<D>()) {
    T* og = static_cast<T*>(p.o);
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < Lq)
          store2(og + ((static_cast<long long>(b) * Lq + rows[r]) * p.H + h) * D + warp * NC +
                     8 * n + 2 * t,
                 o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(Params p, cudaStream_t stream) {
  // the most shared memory a block takes: a full staged chunk
  constexpr size_t kSmemLimit = 232448;  // bytes a block may use on an H100
  static_assert(fwd_smem<T, D>(chunk_rows(D), kRows) <= kSmemLimit &&
                    fwd_smem<T, D>(chunk_rows(D), 1) + kPackSmem <= kSmemLimit,
                "block too large");
  p.kc = staged_rows(p.Lk, D);
  p.brows = p.bias == nullptr || p.sbq == 0 ? 1 : kRows;
  // the packed sweep: one key row an item (stride 0 over heads and query
  // rows), past one staged chunk
  const bool pack = p.bias != nullptr && p.sbq == 0 && p.sbh == 0 && p.Lk > p.kc;
  const size_t smem = fwd_smem<T, D>(p.kc, p.brows) + (pack ? kPackSmem : 0);
  auto kernel = pack ? attention_fwd_kernel<T, D, true> : attention_fwd_kernel<T, D, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3((p.Lq + kRows - 1) / kRows, p.H, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Strides are in
// elements; o is written contiguous [B, Lq, H, D].  bias may be null.
// bits: 0 = no dropout (K1), 1 = hash, 2 = Philox (K2), with the keep
// threshold, the kept value, the seed, the global batch row of row 0 and the
// model's head of head 0 (the bits' counter takes b + row_offset and
// h + head_offset).  tile_counts: null, or kCountSlots pairs of u64 (swept,
// total) to which each block adds its key sub-tiles.  Returns the
// cudaError_t of the launch.
extern "C" int vln_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int dtype, int B, int H, int Lq, int Lk, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sbb, long long sbh, long long sbq, long long sbk,
    float scale, int bits, unsigned int threshold, float keep_scale,
    unsigned long long seed, unsigned int row_offset,
    unsigned int head_offset, void* stream, void* tile_counts) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.bias = static_cast<const float*>(bias);
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.kc = p.brows = 0;
  p.counts = static_cast<unsigned long long*>(tile_counts);
  p.sqb = sqb; p.sql = sql; p.sqh = sqh;
  p.skb = skb; p.skl = skl; p.skh = skh;
  p.svb = svb; p.svl = svl; p.svh = svh;
  p.sbb = sbb; p.sbh = sbh; p.sbq = sbq; p.sbk = sbk;
  p.scale = scale;
  p.drop.bits = bits;
  p.drop.threshold = threshold;
  p.drop.keep_scale = keep_scale;
  p.drop.seed = seed;
  p.drop.row_offset = row_offset;
  p.drop.head_offset = head_offset;
  if (bits < vln::kBitsNone || bits > vln::kBitsPhilox) return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxTiles * kSub)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0: e = dispatch_d<float>(p, D, s); break;
    case 1: e = dispatch_d<__nv_bfloat16>(p, D, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
