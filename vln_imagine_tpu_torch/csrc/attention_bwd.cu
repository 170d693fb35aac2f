// Attention backward for Hopper (sm_90a), with and without attention-probs
// dropout.
//
// Replaces vln_imagine_tpu/ops/attention.py:_bwd_kernel (K4, reached through
// _pallas_attention_bwd) and _bwd_dropout_kernel (K3, through
// _pallas_attention_dropout_bwd).  For every (batch, head), as the TPU
// kernels compute it:
//
//     P  = softmax(Q K^T * scale + bias)      recomputed in f32, never loaded
//     M  = the forward's dropout mask          regenerated (dropout_bits.cuh);
//                                              M = 1 for K4
//     dP = (dO V^T) * M
//     dS = P * (dP - rowsum(dP * P))
//     dQ = dS K * scale,  dK = dS^T Q * scale,  dV = (P * M)^T dO
//
// dQ, dK and dV are written in the input's dtype as [B, L, H, D].  When asked
// (ds != null) the kernel also writes dS as f32 [B, H, Lq, Lk]; the wrapper
// sums it over the bias's broadcast dims to give dBias (the TPU kernels give
// no bias gradient; the JAX package's autodiff of reference_attention does).
//
// Layout.  Q, K, V and dO arrive as strided [B, L, H, D] views (slices of the
// packed projection product, row stride 3*H*D); the last dim is contiguous
// and every row starts on 16 bytes (the wrapper checks both), so tiles are
// copied into shared memory with 16-byte cp.async.  The bias is f32
// [B, 1|H, 1|Lq, Lk] read through its strides (stride 0 where it
// broadcasts), as in attention_fwd.cu.
//
// What bounds it.  At the model's shapes (L <= 80, H 12, D 64) the work is
// five [L, L, D] products per (batch, head), about 10*L*D flops per 2*L*D
// input elements: far below the ~295 flop/byte at which an H100's tensor
// cores, not its memory, become the limit, so by the roofline the kernel is
// bound by bytes.  In practice it is bound by latency and instruction rate:
// a (batch, head) is only a few hundred tensor-core instructions, so what
// counts is how many warps run at once, how long each one's chain of
// dependent steps is, and the fixed cost of two launches.
//
// Design (FlashAttention-2's backward in its deterministic form).  Two
// kernels, launched back to back on the caller's stream; every output
// element is written by exactly one block and nothing is summed with
// atomics, so two calls give the same bits.
//
//   attention_bwd_dq_kernel    one block per (16 query rows, head, batch
//       item).  Its kWarps warps take the key sub-tiles (kSub keys) in turn,
//       staged at most 128 keys (64 at D 128) at a time.  Sweep 0: S and
//       dO V^T, each warp's online row max and sum and rowsum(dP * P)
//       rescaled as the max moves, merged across the warps in warp order
//       into the row max m, 1 / the row sum and delta = rowsum(dP * P) (f32
//       [B, H, Lq] each, written for the second kernel) and, with dropout,
//       the keep bits (one bit an element, [B, H, Lq, ceil(Lk / 16)] words of
//       16 bits in 32).  Sweep 1: P = exp(S - m) / sum, as the forward forms
//       it, dS, the warp's partial dQ += dS K in registers; dS to device
//       memory only for dBias.  When all keys fit one staged chunk, sweep 1
//       reads S and dP back from shared memory instead of recomputing them.
//       The partials are added in warp order through shared memory and
//       written once.
//   attention_bwd_dkdv_kernel  one block per (16 keys, head, batch item).
//       Its warps take the query sub-tiles in turn, recompute S^T = K Q^T
//       and (dO V^T)^T, P from m and 1 / sum, dS from delta and the mask from
//       the keep bits, and sum partial dK and dV in registers, added in warp
//       order at the end.
//
// Why m and 1 / sum and not the one LSE = m + log(sum) of FlashAttention:
// where every key of a row is masked (an item without imaginations under
// the -10000 key mask), the scores and m are near -1e4, where an f32 holds
// steps of 2^-10; m + log(sum) rounded to that step puts an error of up to
// 5e-4 into every P of the row (on an H100: 9.3e-4 in f32 dK / dV against
// the plain version).  S - m and exp(S - m) / sum keep P as exact as the
// forward's.
//
// The split over warps shortens each warp's chain of dependent steps (at
// 80 x 80: two sub-tiles a sweep in place of five) and puts 480 blocks of
// four warps on the card per kernel at B 8, where one block per (batch,
// head) gave 96; a register cap keeps all of them resident at once.  Shared
// memory per block is bounded by the tiles, not by L, so Lq and Lk run to
// the forward's limit; past one chunk (L > 128) the dq kernel stages K and V
// again for sweep 1, which is why long calls cost more per element.  The
// scratch (row max and 1 / sum, delta, keep bits) is allocated by the
// wrapper.  Philox runs once per element, in sweep 0, among the products of
// the same sub-tile; sweep 1 and the dkdv kernel read the packed bits (on an
// H100 at B 8 and L 36 to 270, a dkdv kernel that drew the bits again was 7
// to 11 % slower a call).  The dkdv kernel is launched as a programmatic
// dependent of the dq kernel, so its launch and its K, V staging overlap the
// dq kernel's tail.
// The tiles fix each block's shared memory; static_asserts in launch()
// hold the largest (a full chunk) under the card's 227 KB.
//
// Products.  bf16: mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
// operands from shared memory through ldmatrix (rows padded by 16 bytes, so
// the eight rows of each 8x8 matrix fall in distinct banks).  QK^T and dO V^T
// take the bf16 inputs as they are, so they equal the reference's f32
// products up to the order of summation.  For dQ, dK and dV the f32 P * M and
// dS are rounded to bf16 (round to nearest even) and staged through a small
// per-warp buffer, as FlashAttention does: each term carries a relative
// error of at most 2^-9, far inside the 1e-2 tolerance of the bf16 outputs
// (the CPU emulation in tests/test_torch_attention.py gives its size at every
// training shape).  f32: the same tiles and fragment layout, with the
// products as f32 FMAs on the CUDA cores (no TF32), so the f32 instantiation
// stays within 1e-4 of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

namespace {

using namespace vln;

constexpr int kMaxWords = 1024 / 16;    // keep-bit words of a row at the longest Lk

// blocks per SM the register budget must allow: four at bf16 D <= 64, so
// that the B 8 training calls (up to 480 blocks) run in one wave
template <typename T, int D>
constexpr int min_blocks() { return std::is_same<T, float>::value || D > 64 ? 2 : 4; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // nullptr: no bias
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* ds;          // nullptr: dS not wanted
  float* lse;         // [2, B, H, Lq] scratch: the row max m, 1 / the row sum
  float* delta;       // [B, H, Lq] scratch
  uint32_t* keep;     // [B, H, Lq, ceil(Lk / 16)] scratch, 16 bits a word;
                      // nullptr without dropout
  int B, H, Lq, Lk;
  int kc, qc;         // keys (dq) and queries (dkdv) staged at a time
  long long sqb, sql, sqh;
  long long skb, skl, skh;
  long long svb, svl, svh;
  long long sob, sol, soh;
  long long sbb, sbh, sbq, sbk;
  float scale;
  vln::DropoutParams drop;  // drop.bits == kBitsNone: K4
};

// ------------------------------------------------------------ primitives
// Programmatic dependent launch (sm_90): the dq kernel lets the dkdv kernel
// start early, so its launch and its K, V staging overlap the dq kernel;
// the dkdv kernel waits for the dq kernel's results (complete and visible)
// before it reads them.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ unsigned quad_or(unsigned x) {
  x |= __shfl_xor_sync(0xffffffffu, x, 1);
  return x | __shfl_xor_sync(0xffffffffu, x, 2);
}

// Room of a staged pair of [rows, LD] tiles, which later takes the warps'
// partial sums (f32 [kWarps, kRows, D]).
template <typename T, int D>
__host__ __device__ constexpr size_t chunk_bytes(int rows) {
  return 2 * static_cast<size_t>(rows) * (D + pad<T>()) * sizeof(T) >
                 static_cast<size_t>(kWarps) * kRows * D * sizeof(float)
             ? 2 * static_cast<size_t>(rows) * (D + pad<T>()) * sizeof(T)
             : static_cast<size_t>(kWarps) * kRows * D * sizeof(float);
}

// Shared memory of the dq kernel: Q and dO [kRows, LD]; K and V [kc, LD],
// whose room takes each warp's partial dQ (f32 [kWarps, kRows, D]) once the
// sweeps are done; a [kRows, LDS] dS buffer per warp; each warp's row max,
// sum and dot (f32 [3, kWarps, kRows]); the bias of the staged keys (f32
// [kRows, kc]); the keep bits of the block's rows ([kRows, kMaxWords]); S
// and dP of sweep 0, kept for sweep 1 when all keys fit one chunk (f32
// [2, kRows, kc], each thread's own values; not allocated otherwise).
template <typename T, int D>
__host__ __device__ constexpr size_t dq_smem(int kc, bool keep_sd) {
  return 2 * static_cast<size_t>(kRows) * (D + pad<T>()) * sizeof(T) +
         chunk_bytes<T, D>(kc) +
         static_cast<size_t>(kWarps) * kRows * (kSub + pad<T>()) * sizeof(T) +
         3 * static_cast<size_t>(kWarps) * kRows * sizeof(float) +
         static_cast<size_t>(kRows) * kc * sizeof(float) +
         static_cast<size_t>(kRows) * kMaxWords * sizeof(uint16_t) +
         (keep_sd ? 2 * static_cast<size_t>(kRows) * kc * sizeof(float) : 0);
}

// Shared memory of the dkdv kernel: K and V [kRows, LD]; Q and dO [qc, LD],
// whose room takes each warp's partial dK, then dV (f32 [kWarps, kRows, D]),
// once the queries are done; two [kRows, LDS] buffers per warp ((P*M)^T and
// dS^T); m, 1 / sum and delta of the staged queries (f32 [3, qc]), their
// keep words for the block's keys ([qc], as 32 bits) and the bias (f32
// [qc, kRows]).
template <typename T, int D>
__host__ __device__ constexpr size_t dkdv_smem(int qc) {
  return 2 * static_cast<size_t>(kRows) * (D + pad<T>()) * sizeof(T) +
         chunk_bytes<T, D>(qc) +
         2 * static_cast<size_t>(kWarps) * kRows * (kSub + pad<T>()) * sizeof(T) +
         (4 + kRows) * static_cast<size_t>(qc) * sizeof(float);
}

// Each warp's partial [kRows, D] sums (in `part`, f32 [kWarps, kRows, D]),
// added in warp order and written as rows row0.. of a [B, L, H, D] output,
// times `scale`; rows >= L are dropped.  Called by the whole block after a
// __syncthreads that follows the partials' stores.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* out, const float* part, int b, int h,
                                           int H, int row0, int L, float scale) {
  for (int idx = 2 * threadIdx.x; idx < kRows * D; idx += 2 * kThreads) {
    const int r = idx / D, d = idx % D, i = row0 + r;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      x += part[w * kRows * D + idx];
      y += part[w * kRows * D + idx + 1];
    }
    if (i < L)
      store2(out + ((static_cast<long long>(b) * L + i) * H + h) * D + d, x * scale,
             y * scale);
  }
}

// ------------------------------------------------ pass 1: stats and dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<T, D>())
    attention_bwd_dq_kernel(const Params p) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int LD = D + pad<T>();
  constexpr int LDS = kSub + pad<T>();
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = p.kc;
  T* qs = reinterpret_cast<T*>(smem);   // [kRows][LD]
  T* dos = qs + kRows * LD;             // [kRows][LD]
  T* ks = dos + kRows * LD;             // [kc][LD]
  T* vs = ks + kc * LD;                 // [kc][LD]
  float* part = reinterpret_cast<float*>(ks);  // after the sweeps
  T* scr = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(ks) +
                                chunk_bytes<T, D>(kc));  // [kWarps][kRows][LDS]
  float* stat = reinterpret_cast<float*>(scr + kWarps * kRows * LDS);  // [3][kWarps][kRows]
  float* bs = stat + 3 * kWarps * kRows;                        // [kRows][kc]
  uint16_t* kb = reinterpret_cast<uint16_t*>(bs + kRows * kc);  // [kRows][kMaxWords]
  float* sd = reinterpret_cast<float*>(kb + kRows * kMaxWords);  // [kc / kSub][2][8][32]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Lq = p.Lq, Lk = p.Lk, nw = (Lk + 15) / 16;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const bool dropout = p.drop.bits != vln::kBitsNone;
  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const float* bias = p.bias == nullptr ? nullptr : p.bias + b * p.sbb + h * p.sbh;

  launch_dependents();  // the dkdv kernel may start staging K and V
  stage<T, D>(qs, qg, p.sql, row0, Lq, kRows);
  stage<T, D>(dos, dog, p.sol, row0, Lq, kRows);

  T* wscr = scr + warp * kRows * LDS;
  const int rows[2] = {row0 + g, row0 + g + 8};

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
  float rmax[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float dq[ND][4] = {};
  const int nchunks = (Lk + kc - 1) / kc;
  // one chunk: sweep 1 reads S and dP back from sweep 0 instead of
  // recomputing them
  const bool keep_sd = nchunks == 1;

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kc, nk = min(kc, Lk - c0);
      if (sweep == 0 || nchunks > 1) {
        __syncthreads();  // every warp is done with the previous chunk
        stage<T, D>(ks, kg, p.skl, c0, Lk, round_up(nk, kSub));
        stage<T, D>(vs, vg, p.svl, c0, Lk, round_up(nk, kSub));
        for (int x = threadIdx.x; x < kRows * kc; x += kThreads) {
          const int i = row0 + x / kc, j = c0 + x % kc;
          const bool valid = bias != nullptr && i < Lq && j < Lk;
          cp_async4(bs + x, valid ? bias + i * p.sbq + j * p.sbk : p.lse, valid);
        }
        cp_async_wait_all();
        __syncthreads();
      }
      // the warps take the chunk's key sub-tiles in turn, the same ones in
      // both sweeps
      for (int s0 = warp * kSub; s0 < nk; s0 += kWarps * kSub) {
        const int word = (c0 + s0) / 16;  // keep-bit word of this sub-tile
        float* sdt = sd + (s0 / kSub) * 2 * 8 * 32 + lane;  // this thread's S, dP
        float s[kNT][4] = {}, dp[kNT][4] = {};
        if (sweep == 1 && keep_sd) {
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            s[v / 4][v % 4] = sdt[v * 32];
            dp[v / 4][v % 4] = sdt[(8 + v) * 32];
          }
        } else {
          // S = Q K^T * scale + bias (-inf past Lk), dP = (dO V^T) * M; the
          // keep bits drawn in sweep 0 (Philox or hash), read back after
          unsigned kept[2] = {0u, 0u};
          const bool draw = dropout && sweep == 0;
          if (dropout && !draw) {
#pragma unroll
            for (int r = 0; r < 2; ++r) kept[r] = kb[(g + 8 * r) * kMaxWords + word];
          }
          gemm_nt<T, D, kNT>(s, qs, LD, ks + s0 * LD, LD);
          gemm_nt<T, D, kNT>(dp, dos, LD, vs + s0 * LD, LD);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int bit = 8 * n + 2 * t + (e & 1), j = c0 + s0 + bit;
              s[n][e] = j < Lk ? s[n][e] * p.scale + bs[(g + 8 * r) * kc + s0 + bit]
                               : -INFINITY;
              if (dropout && j < Lk) {
                if (draw && vln::dropout_keep(p.drop, b, h, rows[r], j))
                  kept[r] |= 1u << bit;
                dp[n][e] *= (kept[r] >> bit) & 1u ? p.drop.keep_scale : 0.f;
              }
            }
          }
          if (draw) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const unsigned w = quad_or(kept[r]);
              if (t == 0) {
                kb[(g + 8 * r) * kMaxWords + word] = static_cast<uint16_t>(w);
                if (rows[r] < Lq) p.keep[(bh * Lq + rows[r]) * nw + word] = w;
              }
            }
          }
          if (sweep == 0 && keep_sd) {
#pragma unroll
            for (int v = 0; v < 8; ++v) {
              sdt[v * 32] = s[v / 4][v % 4];
              sdt[(8 + v) * 32] = dp[v / 4][v % 4];
            }
          }
        }
        if (sweep == 0) {
          // online softmax statistics and rowsum(dP * exp(S - max))
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float m = mx[r];
#pragma unroll
            for (int n = 0; n < kNT; ++n)
              m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
            m = quad_max(m);
            const float corr = expf(mx[r] - m);
            sum[r] *= corr;
            dot[r] *= corr;
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                const float ev = expf(s[n][e] - m);
                sum[r] += ev;
                dot[r] = fmaf(ev, dp[n][e], dot[r]);
              }
            }
            mx[r] = m;
          }
        } else {
          // P = exp(S - m) / sum, dS = P * (dP - delta), dQ += dS K
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float pv = expf(s[n][e] - rmax[r]) * rinv[r];
              s[n][e] = pv * (dp[n][e] - delta[r]);
            }
          }
          if (p.ds != nullptr) {
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = rows[e >> 1], j = c0 + s0 + 8 * n + 2 * t + (e & 1);
                if (i < Lq && j < Lk) p.ds[(bh * Lq + i) * Lk + j] = s[n][e];
              }
            }
          }
          store_acc<T, kNT>(wscr, LDS, s);
          __syncwarp();
          gemm_nn<T, kSub, ND>(dq, wscr, LDS, ks + s0 * LD, LD);
          __syncwarp();  // the buffer is read before the next sub-tile writes it
        }
      }
    }
    if (sweep == 0) {
      // merge the warps' statistics, in warp order: every warp gets the same
      // m, 1 / sum and delta
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(sum[r]), d = quad_sum(dot[r]);
        if (t == 0) {
          stat[(0 * kWarps + warp) * kRows + g + 8 * r] = mx[r];
          stat[(1 * kWarps + warp) * kRows + g + 8 * r] = l;
          stat[(2 * kWarps + warp) * kRows + g + 8 * r] = d;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        float m = -INFINITY, l = 0.f, d = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, stat[w * kRows + row]);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = expf(stat[w * kRows + row] - m);  // 0 for a warp with no keys
          l = fmaf(stat[(kWarps + w) * kRows + row], f, l);
          d = fmaf(stat[(2 * kWarps + w) * kRows + row], f, d);
        }
        rmax[r] = m;
        rinv[r] = 1.f / l;
        delta[r] = d / l;
        if (warp == 0 && t == 0 && rows[r] < Lq) {
          const long long nrows = static_cast<long long>(p.B) * p.H * Lq;
          p.lse[bh * Lq + rows[r]] = m;
          p.lse[nrows + bh * Lq + rows[r]] = rinv[r];
          p.delta[bh * Lq + rows[r]] = delta[r];
        }
      }
    }
  }

  __syncthreads();  // K and V are done with: their room takes the partials
  store_acc<float, ND>(part + warp * kRows * D, D, dq);
  __syncthreads();
  write_rows<T, D>(static_cast<T*>(p.dq), part, b, h, p.H, row0, Lq, p.scale);
}

// ---------------------------------------------------- pass 2: dK and dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<T, D>())
    attention_bwd_dkdv_kernel(const Params p) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int LD = D + pad<T>();
  constexpr int LDS = kSub + pad<T>();
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qc = p.qc;
  T* ks = reinterpret_cast<T*>(smem);   // [kRows][LD]
  T* vs = ks + kRows * LD;              // [kRows][LD]
  T* qs = vs + kRows * LD;              // [qc][LD]
  T* dos = qs + qc * LD;                // [qc][LD]
  float* part = reinterpret_cast<float*>(qs);  // after the queries
  T* scr = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(qs) +
                                chunk_bytes<T, D>(qc));  // [kWarps][2][kRows][LDS]
  float* max_s = reinterpret_cast<float*>(scr + 2 * kWarps * kRows * LDS);  // [qc]
  float* inv_s = max_s + qc;                                                 // [qc]
  float* delta_s = inv_s + qc;                                               // [qc]
  unsigned* kw_s = reinterpret_cast<unsigned*>(delta_s + qc);                // [qc]
  float* bs = reinterpret_cast<float*>(kw_s + qc);                           // [qc][kRows]

  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Lq = p.Lq, Lk = p.Lk, nw = (Lk + 15) / 16;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const bool dropout = p.drop.bits != vln::kBitsNone;
  const long long nrows = static_cast<long long>(p.B) * p.H * Lq;
  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const float* bias = p.bias == nullptr ? nullptr : p.bias + b * p.sbb + h * p.sbh;

  stage<T, D>(ks, kg, p.skl, key0, Lk, kRows);
  stage<T, D>(vs, vg, p.svl, key0, Lk, kRows);

  T* wpm = scr + 2 * warp * kRows * LDS;
  T* wds = wpm + kRows * LDS;
  const int keys[2] = {key0 + g, key0 + g + 8};  // one keep word: bits 0..15

  float dk[ND][4] = {}, dv[ND][4] = {};
  for (int c0 = 0; c0 < Lq; c0 += qc) {
    const int nq = min(qc, Lq - c0), nq_pad = round_up(nq, kSub);
    __syncthreads();  // every warp is done with the previous chunk
    stage<T, D>(qs, qg, p.sql, c0, Lq, nq_pad);
    stage<T, D>(dos, dog, p.sol, c0, Lq, nq_pad);
    if (c0 == 0) wait_for_primary();  // m, 1 / sum, delta and keep bits: the dq kernel's
    for (int x = threadIdx.x; x < nq_pad; x += kThreads) {
      const int i = c0 + x;
      const bool valid = i < Lq, bits = valid && dropout;
      cp_async4(max_s + x, p.lse + bh * Lq + (valid ? i : 0), valid);
      cp_async4(inv_s + x, p.lse + nrows + bh * Lq + (valid ? i : 0), valid);
      cp_async4(delta_s + x, p.delta + bh * Lq + (valid ? i : 0), valid);
      cp_async4(kw_s + x,
                bits ? static_cast<const void*>(p.keep + (bh * Lq + i) * nw + key0 / 16)
                     : static_cast<const void*>(p.lse),
                bits);
    }
    for (int x = threadIdx.x; x < nq_pad * kRows; x += kThreads) {
      const int i = c0 + x / kRows, j = key0 + x % kRows;
      const bool valid = bias != nullptr && i < Lq && j < Lk;
      cp_async4(bs + x, valid ? bias + i * p.sbq + j * p.sbk : p.lse, valid);
    }
    cp_async_wait_all();
    __syncthreads();
    // the warps take the chunk's query sub-tiles in turn
    for (int s0 = warp * kSub; s0 < nq; s0 += kWarps * kSub) {
      // transposed scores: rows are the block's keys, columns queries
      float s[kNT][4] = {}, dp[kNT][4] = {};
      gemm_nt<T, D, kNT>(s, ks, LD, qs + s0 * LD, LD);
      gemm_nt<T, D, kNT>(dp, vs, LD, dos + s0 * LD, LD);
      float pm[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = s0 + 8 * n + 2 * t + (e & 1), i = c0 + col;
          const int j = keys[e >> 1];
          float pv = 0.f, mv = 1.f;
          if (i < Lq && j < Lk) {
            pv = expf(s[n][e] * p.scale + bs[col * kRows + j - key0] - max_s[col]) *
                 inv_s[col];
            if (dropout) mv = (kw_s[col] >> (j - key0)) & 1u ? p.drop.keep_scale : 0.f;
          }
          s[n][e] = pv * (dp[n][e] * mv - delta_s[col]);  // dS^T
          pm[n][e] = pv * mv;                             // (P * M)^T
        }
      }
      store_acc<T, kNT>(wpm, LDS, pm);
      store_acc<T, kNT>(wds, LDS, s);
      __syncwarp();
      gemm_nn<T, kSub, ND>(dv, wpm, LDS, dos + s0 * LD, LD);
      gemm_nn<T, kSub, ND>(dk, wds, LDS, qs + s0 * LD, LD);
      __syncwarp();  // the buffers are read before the next sub-tile writes them
    }
  }

  __syncthreads();  // Q and dO are done with: their room takes the partials
  store_acc<float, ND>(part + warp * kRows * D, D, dk);
  __syncthreads();
  write_rows<T, D>(static_cast<T*>(p.dk), part, b, h, p.H, key0, Lk, p.scale);
  __syncthreads();
  store_acc<float, ND>(part + warp * kRows * D, D, dv);
  __syncthreads();
  write_rows<T, D>(static_cast<T*>(p.dv), part, b, h, p.H, key0, Lk, 1.f);
}

// ------------------------------------------------------------- launching
template <typename T, int D>
cudaError_t launch(Params p, cudaStream_t stream) {
  // the most shared memory a block takes: a full staged chunk
  constexpr size_t kSmemLimit = 232448;  // bytes a block may use on an H100
  static_assert(dq_smem<T, D>(chunk_rows(D), true) <= kSmemLimit, "dq block too large");
  static_assert(dkdv_smem<T, D>(chunk_rows(D)) <= kSmemLimit, "dkdv block too large");
  p.kc = staged_rows(p.Lk, D);
  p.qc = staged_rows(p.Lq, D);
  const size_t smem1 = dq_smem<T, D>(p.kc, p.Lk <= chunk_rows(D));
  const size_t smem2 = dkdv_smem<T, D>(p.qc);
  auto k1 = attention_bwd_dq_kernel<T, D>;
  auto k2 = attention_bwd_dkdv_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem1));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem2));
  if (e != cudaSuccess) return e;
  k1<<<dim3((p.Lq + kRows - 1) / kRows, p.H, p.B), kThreads, smem1, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the dkdv kernel as a programmatic dependent of the dq kernel
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.Lk + kRows - 1) / kRows, p.H, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k2, p);
  if (e != cudaSuccess) return e;
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv alike).
// Strides are in elements; dq/dk/dv are written contiguous [B, L, H, D].
// bias and ds may be null.  lse: f32 [2, B, H, Lq] scratch (each row's max,
// then 1 / its sum), delta: f32 [B, H, Lq] scratch; keep:
// [B, H, Lq, ceil(Lk / 16)] 32-bit scratch (16 keep bits a word), needed
// with dropout only.
// bits: 0 = no dropout (K4), 1 = hash, 2 = Philox (K3), with the forward's
// keep threshold, kept value, seed, row offset and head offset.  Launches
// both kernels and returns
// the first cudaError_t.
extern "C" int vln_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, void* dq, void* dk, void* dv, void* ds,
    void* lse, void* delta, void* keep,
    int dtype, int B, int H, int Lq, int Lk, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    long long sbb, long long sbh, long long sbq, long long sbk,
    float scale, int bits, unsigned int threshold, float keep_scale,
    unsigned long long seed, unsigned int row_offset,
    unsigned int head_offset, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.ds = static_cast<float*>(ds);
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.keep = static_cast<uint32_t*>(keep);
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.kc = p.qc = 0;
  p.sqb = sqb; p.sql = sql; p.sqh = sqh;
  p.skb = skb; p.skl = skl; p.skh = skh;
  p.svb = svb; p.svl = svl; p.svh = svh;
  p.sob = sob; p.sol = sol; p.soh = soh;
  p.sbb = sbb; p.sbh = sbh; p.sbq = sbq; p.sbk = sbk;
  p.scale = scale;
  p.drop.bits = bits;
  p.drop.threshold = threshold;
  p.drop.keep_scale = keep_scale;
  p.drop.seed = seed;
  p.drop.row_offset = row_offset;
  p.drop.head_offset = head_offset;
  if (bits < vln::kBitsNone || bits > vln::kBitsPhilox) return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  if (lse == nullptr || delta == nullptr) return cudaErrorInvalidValue;
  if (bits != vln::kBitsNone && keep == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0: e = dispatch_d<float>(p, D, s); break;
    case 1: e = dispatch_d<__nv_bfloat16>(p, D, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
