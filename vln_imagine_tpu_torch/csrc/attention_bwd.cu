// Attention backward for Hopper (sm_90a), with and without attention-probs
// dropout.
//
// Replaces vln_imagine_tpu/ops/attention.py:_bwd_kernel (K4, reached through
// _pallas_attention_bwd) and _bwd_dropout_kernel (K3, through
// _pallas_attention_dropout_bwd).  For every (batch, head), as the TPU
// kernels compute it, all in f32:
//
//     P  = softmax(Q K^T * scale + bias)      recomputed, never loaded
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
// packed projection product); only the last dim must be contiguous.  The
// bias is f32 [B, 1|H, 1|Lq, Lk] read through its strides (stride 0 where it
// broadcasts), as in attention_fwd.cu.
//
// What bounds it.  At the model's shapes (L <= 80, H 12, D 64) the work is
// five [L, L, D] products per (batch, head), about 10*L*D flops per 2*L*D
// input elements: far below the ~295 flop/byte at which an H100's tensor
// cores, not its memory, become the limit, so by the roofline the kernel is
// bound by bytes.  This first version runs its products on the CUDA cores
// from shared memory, which bounds it in practice (shared-memory loads per
// FMA); tensor cores (mma.sync / wgmma) and register tiling are later work.
//
// Design.  One block per (head, batch item) holds all Lq rows: Q, dO, K, V
// (f32, rows padded to D+1 words so that lanes reading different rows hit
// different banks) and P, dP/dS (f32 [Lq, Lk+1]) live in shared memory, so
// dK and dV are summed over the query rows inside the block, in a fixed
// order, with no atomics: a train step on the card is reproducible.  The
// price is that Lq and Lk are bounded by the 227 KB of shared memory
// (80 x 80 at D 64 takes 141 KB; the wrapper raises beyond the limit) and
// that B*H blocks (96 at the training batch) fill less than one wave of the
// card's 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dropout_bits.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // nullptr: no bias
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* ds;  // nullptr: dS not wanted
  int B, H, Lq, Lk;
  long long sqb, sql, sqh;
  long long skb, skl, skh;
  long long svb, svl, svh;
  long long sob, sol, soh;
  long long sbb, sbh, sbq, sbk;
  float scale;
  vln::DropoutParams drop;  // drop.bits == kBitsNone: K4
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [0, n) of a strided [L, D] slice into shared memory, f32, stride D+1
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride,
                                      int n) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] = to_f32(src[r * row_stride + d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_kernel(const Params p) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int DS = D + 1;
  extern __shared__ float smem[];
  const int Lq = p.Lq, Lk = p.Lk, PS = Lk + 1;
  float* qs = smem;              // [Lq][DS]
  float* dos = qs + Lq * DS;     // [Lq][DS]
  float* ks = dos + Lq * DS;     // [Lk][DS]
  float* vs = ks + Lk * DS;      // [Lk][DS]
  float* ps = vs + Lk * DS;      // [Lq][PS] scores -> P -> P * M
  float* dss = ps + Lq * PS;     // [Lq][PS] dO V^T -> dP -> dS
  unsigned char* kept = reinterpret_cast<unsigned char*>(dss + Lq * PS);  // [Lq][Lk]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool dropout = p.drop.bits != vln::kBitsNone;

  stage<T, D>(qs, static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh, p.sql, Lq);
  stage<T, D>(dos, static_cast<const T*>(p.dout) + b * p.sob + h * p.soh, p.sol,
              Lq);
  stage<T, D>(ks, static_cast<const T*>(p.k) + b * p.skb + h * p.skh, p.skl, Lk);
  stage<T, D>(vs, static_cast<const T*>(p.v) + b * p.svb + h * p.svh, p.svl, Lk);
  __syncthreads();

  // ---- s = q_i . k_j * scale + bias,  g = do_i . v_j ----------------------
  for (int idx = threadIdx.x; idx < Lq * Lk; idx += kThreads) {
    const int i = idx / Lk, j = idx % Lk;
    const float* qr = qs + i * DS;
    const float* kr = ks + j * DS;
    const float* dr = dos + i * DS;
    const float* vr = vs + j * DS;
    float s = 0.f, g = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(qr[d], kr[d], s);
      g = fmaf(dr[d], vr[d], g);
    }
    s *= p.scale;
    if (p.bias != nullptr)
      s += p.bias[b * p.sbb + h * p.sbh + i * p.sbq + j * p.sbk];
    ps[i * PS + j] = s;
    dss[i * PS + j] = g;
  }
  __syncthreads();

  // ---- per row (one warp): P, dP = g * M, dS = P * (dP - rowsum(dP * P)) --
  for (int i = warp; i < Lq; i += kWarps) {
    float* prow = ps + i * PS;
    float* drow = dss + i * PS;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dot = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float pv = prow[j] / sum;
      float dp = drow[j];
      if (dropout) {
        const float mv = vln::dropout_mask(p.drop, b, h, i, j);
        kept[i * Lk + j] = mv != 0.f;
        dp *= mv;
      }
      prow[j] = pv;
      drow[j] = dp;
      dot += dp * pv;
    }
    dot = warp_sum(dot);
    for (int j = lane; j < Lk; j += 32) {
      const float pv = prow[j];
      drow[j] = pv * (drow[j] - dot);
      if (dropout) prow[j] = pv * (kept[i * Lk + j] ? p.drop.keep_scale : 0.f);
    }
  }
  __syncthreads();

  // ---- dQ = dS K * scale ----------------------------------------------------
  T* dq = static_cast<T*>(p.dq);
  for (int idx = threadIdx.x; idx < Lq * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const float* drow = dss + i * PS;
    float acc = 0.f;
    for (int j = 0; j < Lk; ++j) acc = fmaf(drow[j], ks[j * DS + d], acc);
    dq[((static_cast<long long>(b) * Lq + i) * p.H + h) * D + d] =
        from_f32<T>(acc * p.scale);
  }

  // ---- dK = dS^T Q * scale,  dV = (P * M)^T dO -------------------------------
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  for (int idx = threadIdx.x; idx < Lk * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    float ak = 0.f, av = 0.f;
    for (int i = 0; i < Lq; ++i) {
      ak = fmaf(dss[i * PS + j], qs[i * DS + d], ak);
      av = fmaf(ps[i * PS + j], dos[i * DS + d], av);
    }
    const long long o = ((static_cast<long long>(b) * Lk + j) * p.H + h) * D + d;
    dk[o] = from_f32<T>(ak * p.scale);
    dv[o] = from_f32<T>(av);
  }

  if (p.ds != nullptr) {
    float* dsg = p.ds + (static_cast<long long>(b) * p.H + h) * Lq * Lk;
    for (int idx = threadIdx.x; idx < Lq * Lk; idx += kThreads)
      dsg[idx] = dss[(idx / Lk) * PS + idx % Lk];
  }
}

size_t smem_bytes(int Lq, int Lk, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(Lq) * (D + 1) +
                          2 * static_cast<size_t>(Lk) * (D + 1) +
                          2 * static_cast<size_t>(Lq) * (Lk + 1)) +
         static_cast<size_t>(Lq) * Lk + 16;
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Lq, p.Lk, D);
  auto kernel = attention_bwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(p.H, p.B), kThreads, smem, stream>>>(p);
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
// bias and ds may be null.  bits: 0 = no dropout (K4), 1 = hash, 2 = Philox
// (K3), with the forward's keep threshold, kept value and seed.  Returns the
// cudaError_t of the launch.
extern "C" int vln_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, void* dq, void* dk, void* dv, void* ds,
    int dtype, int B, int H, int Lq, int Lk, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    long long sbb, long long sbh, long long sbq, long long sbk,
    float scale, int bits, unsigned int threshold, float keep_scale,
    unsigned long long seed, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.ds = static_cast<float*>(ds);
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
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
  if (bits < vln::kBitsNone || bits > vln::kBitsPhilox) return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0: e = dispatch_d<float>(p, D, s); break;
    case 1: e = dispatch_d<__nv_bfloat16>(p, D, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
