// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces vln_imagine_tpu/ops/attention.py:_fwd_kernel (the Pallas TPU
// kernel reached through _pallas_attention_fwd).  For every (batch, head):
//
//     O = softmax(Q K^T * scale + bias) V
//
// in the same order as the TPU kernel: f32 scores, + bias, row max, exp,
// normalise, P rounded to V's dtype, P V accumulated in f32, O in Q's dtype.
//
// Layout.  Q, K, V and O are [B, L, H, D] (the projection layout of the
// model's packed QKV product), so no head transposes surround the kernel.
// Q/K/V arrive as strided views (row stride 3*H*D when they are slices of
// the packed product); only the last dim must be contiguous.  The additive
// bias is f32 [B, 1|H, 1|Lq, Lk] read through its strides, so the [B,1,1,Lk]
// padding mask is read with stride 0 over heads and query rows and never
// materialised.
//
// What bounds it.  At the model's shapes (L <= 80, H 12, D 64) the work is
// about 4*L*D flops per byte of Q/K/V/O, far below the ~295 flop/byte at
// which an H100's tensor cores, and not its memory, become the limit: the
// kernel is bound by bytes.  The design therefore keeps everything of size
// [Lq, Lk] out of device memory: scores and probabilities live in shared
// memory only, each block reads its Q tile and its head's K and V once and
// writes its O tile once.  Blocks of the same head re-read K and V; those
// reads are served by L2 (K and V of one head are at most a few tens of KB).
//
// Design.  One block per (query tile of 16 rows, head, batch item), four
// warps, four query rows per warp.  K is staged chunk by chunk (64 keys)
// into shared memory transposed, so that the 32 lanes of a warp, each
// scoring its own key, read consecutive words.  The full f32 score row of
// each query stays in shared memory; max and sum are warp shuffles.  V is
// then staged chunk by chunk and every lane accumulates D/32 output columns.
// Plain FMA on the CUDA cores: tensor cores (mma.sync / wgmma) and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kKeyChunk = 64;
constexpr int kThreads = kWarps * 32;
constexpr int kKtStride = kKeyChunk + 1;  // padded row of the transposed K chunk

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // nullptr: no bias
  void* o;
  int B, H, Lq, Lk;
  long long sqb, sql, sqh;
  long long skb, skl, skh;
  long long svb, svl, svh;
  long long sbb, sbh, sbq, sbk;
  float scale;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const Params p) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int kCols = D / 32;  // output columns per lane

  extern __shared__ float smem[];
  const int Lk = p.Lk;
  float* qs = smem;                          // [kRowsPerBlock][D]
  float* ss = qs + kRowsPerBlock * D;        // [kRowsPerBlock][Lk] scores, probs
  float* kv = ss + kRowsPerBlock * Lk;       // K chunk [D][kKtStride] | V chunk [kKeyChunk][D]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;      // this warp's first row in the tile

  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;

  for (int idx = threadIdx.x; idx < kRowsPerBlock * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = row0 + r;
    qs[idx] = i < p.Lq ? to_f32(qg[i * p.sql + d]) : 0.f;
  }

  // ---- scores: s[i, j] = (q_i . k_j) * scale + bias[i, j] -----------------
  for (int c0 = 0; c0 < Lk; c0 += kKeyChunk) {
    const int nk = min(kKeyChunk, Lk - c0);
    __syncthreads();  // Q staged; previous K chunk consumed
    for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv[d * kKtStride + j] = to_f32(kg[(c0 + j) * p.skl + d]);
    }
    __syncthreads();

    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0 = kv[d * kKtStride + lane];
      const float k1 = kv[d * kKtStride + lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qs[(wrow + r) * D + d];
        acc[r][0] = fmaf(qv, k0, acc[r][0]);
        acc[r][1] = fmaf(qv, k1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + wrow + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j < nk) {
          float s = acc[r][t] * p.scale;
          if (p.bias != nullptr && i < p.Lq)
            s += p.bias[b * p.sbb + h * p.sbh + i * p.sbq + (c0 + j) * p.sbk];
          ss[(wrow + r) * Lk + c0 + j] = s;
        }
      }
    }
  }
  __syncwarp();

  // ---- softmax over each full row, P rounded to V's dtype -----------------
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* srow = ss + (wrow + r) * Lk;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32)
      srow[j] = to_f32(from_f32<T>(srow[j] / sum));
  }
  __syncwarp();

  // ---- O = P V, f32 accumulation -----------------------------------------
  float o[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < kCols; ++t) o[r][t] = 0.f;

  for (int c0 = 0; c0 < Lk; c0 += kKeyChunk) {
    const int nk = min(kKeyChunk, Lk - c0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv[j * D + d] = to_f32(vg[(c0 + j) * p.svl + d]);
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float vv[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) vv[t] = kv[j * D + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pr = ss[(wrow + r) * Lk + c0 + j];
#pragma unroll
        for (int t = 0; t < kCols; ++t) o[r][t] = fmaf(pr, vv[t], o[r][t]);
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + wrow + r;
    if (i < p.Lq) {
      T* orow = og + ((static_cast<long long>(b) * p.Lq + i) * p.H + h) * D;
#pragma unroll
      for (int t = 0; t < kCols; ++t) orow[lane + 32 * t] = from_f32<T>(o[r][t]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRowsPerBlock) * D +
                       static_cast<size_t>(kRowsPerBlock) * p.Lk +
                       static_cast<size_t>(D) * kKtStride);
  auto kernel = attention_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Lq + kRowsPerBlock - 1) / kRowsPerBlock, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
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
// elements.  bias may be null.  Returns the cudaError_t of the launch.
extern "C" int vln_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int dtype, int B, int H, int Lq, int Lk, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sbb, long long sbh, long long sbq, long long sbk,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.bias = static_cast<const float*>(bias);
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.sqb = sqb; p.sql = sql; p.sqh = sqh;
  p.skb = skb; p.skl = skl; p.skh = skh;
  p.svb = svb; p.svl = svl; p.svh = svh;
  p.sbb = sbb; p.sbh = sbh; p.sbq = sbq; p.sbk = sbk;
  p.scale = scale;
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
