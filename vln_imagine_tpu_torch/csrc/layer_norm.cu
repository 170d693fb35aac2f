// LayerNorm(x [+ residual]) in f32 for Hopper (sm_90a): the model's residual
// add and f32 LayerNorm (models/bert.py:LayerNormF32) in one pass.
//
// Replaces no TPU kernel.  On the TPU, XLA fuses the add, the casts and the
// LayerNorm into one loop of its own; in PyTorch they are up to four ATen
// kernels (the add, the upcast to f32, the f32 LayerNorm, the downcast back),
// each a pass over device memory.  This kernel is that chain, with its
// numbers, in one pass:
//
//     s    = x + r      f32; rounded to bf16 when x and r are both bf16
//                       (ATen's bf16 add rounds it), kept in f32 when either
//                       is f32; s = x without a residual
//     mean = sum(s) / H,  var = sum((s - mean)^2) / H           (f32)
//     y    = w * ((s - mean) * rsqrt(var + eps)) + b            (f32)
//
// y rounded once to the output's dtype, the promotion of x's and r's (what
// `x + r` gives): f32 when either is f32, else bf16.  The statistics are
// two sums over values held in registers, where ATen's kernel takes Welford
// sums, so the two may differ in the last bits of f32.
//
// What bounds it.  A dozen flops an element beside 4 to 12 bytes (read x and
// r once, write y once): bound by bytes, 3.35 TB/s on an H100.
//
// Design.  One warp a row.  Lane l holds the row's 8-element chunks l,
// l + 32, ... (at H 768 three chunks: three 16-byte loads of bf16, six of
// f32), so the row stays in registers: mean and variance are butterfly
// shuffle sums over them, and memory is read once.  A block of kWarps warps
// stages w and b [H] in shared memory once, through the read-only path, and
// its warps walk the rows with a grid stride, the grid as many blocks as the
// card holds at once, so the staging is paid once a block and not once a
// few rows.  Loads and stores are 16 bytes wide; the rows of x and r start
// on 16 bytes at any row stride (the wrapper checks it), the output is
// contiguous.  No atomics and a fixed order of sums: two calls give the same
// bits, and the butterfly leaves every lane the same sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;   // rows in flight a block: 256 threads
constexpr int kChunk = 8;   // elements a lane loads at once
constexpr int kMaxH = 4096;

__device__ __forceinline__ void load_chunk(const float* p, float (&v)[kChunk]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_chunk(const bf16* p, float (&v)[kChunk]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i in the low half (exact upcast)
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_chunk(float* p, const float (&y)[kChunk]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store_chunk(bf16* p, const float (&y)[kChunk]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                                            pack2(y[4], y[5]), pack2(y[6], y[7]));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// the output's dtype: the promotion of x's and the residual's
template <typename TX, typename TR, bool kRes>
using OutT = std::conditional_t<std::is_same<TX, float>::value
                                    || (kRes && std::is_same<TR, float>::value),
                                float, bf16>;

struct Args {
  const void* x;
  const void* r;        // nullptr: no residual
  const float* w;
  const float* b;
  void* out;
  long long rows;
  int H;
  long long sx, sr;     // row strides of x and r, in elements
  float eps;
};

// kN: chunk slots a lane holds, at least H / 256 rounded up
template <typename TX, typename TR, bool kRes, int kN>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(Args a) {
  using TO = OutT<TX, TR, kRes>;
  __shared__ __align__(16) float sw[kN * 32 * kChunk];
  __shared__ __align__(16) float sb[kN * 32 * kChunk];
  const int H = a.H;
  for (int i = threadIdx.x; i < H; i += kWarps * 32) {
    sw[i] = __ldg(a.w + i);
    sb[i] = __ldg(a.b + i);
  }
  __syncthreads();

  const TX* __restrict__ x = static_cast<const TX*>(a.x);
  const TR* __restrict__ r = static_cast<const TR*>(a.r);
  TO* __restrict__ out = static_cast<TO*>(a.out);
  const int lane = threadIdx.x & 31;
  const int chunks = H / kChunk;
  const float h = static_cast<float>(H);
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < a.rows; row += step) {
    float v[kN][kChunk];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        load_chunk(x + row * a.sx + c * kChunk, v[i]);
        if constexpr (kRes) {
          float t[kChunk];
          load_chunk(r + row * a.sr + c * kChunk, t);
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            v[i][j] += t[j];
            if constexpr (std::is_same<TO, bf16>::value)
              v[i][j] = __bfloat162float(__float2bfloat16_rn(v[i][j]));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) v[i][j] = 0.f;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int j = 0; j < kChunk; ++j) sum += v[i][j];
    const float mean = warp_sum(sum) / h;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (lane + 32 * i < chunks) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float d = v[i][j] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / h + a.eps);
    TO* orow = out + row * H;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        const float4* wc = reinterpret_cast<const float4*>(sw + c * kChunk);
        const float4* bc = reinterpret_cast<const float4*>(sb + c * kChunk);
        const float4 w0 = wc[0], w1 = wc[1], b0 = bc[0], b1 = bc[1];
        const float wv[kChunk] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float bv[kChunk] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float y[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          y[j] = wv[j] * ((v[i][j] - mean) * rstd) + bv[j];
        store_chunk(orow + c * kChunk, y);
      }
    }
  }
}

template <typename TX, typename TR, bool kRes, int kN>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const auto kernel = layer_norm_kernel<TX, TR, kRes, kN>;
  // blocks an SM holds at once: the same on every H100, asked once
  static const int per_sm = [kernel] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWarps * 32, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long need = (a.rows + kWarps - 1) / kWarps;
  const long long most = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(need < most ? need : most);
  kernel<<<grid, kWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TR, bool kRes>
cudaError_t dispatch_n(const Args& a, cudaStream_t s) {
  const int need = (a.H + 32 * kChunk - 1) / (32 * kChunk);
  if (need <= 1) return launch<TX, TR, kRes, 1>(a, s);
  if (need <= 2) return launch<TX, TR, kRes, 2>(a, s);
  if (need <= 3) return launch<TX, TR, kRes, 3>(a, s);
  if (need <= 4) return launch<TX, TR, kRes, 4>(a, s);
  if (need <= 6) return launch<TX, TR, kRes, 6>(a, s);
  if (need <= 8) return launch<TX, TR, kRes, 8>(a, s);
  if (need <= 12) return launch<TX, TR, kRes, 12>(a, s);
  return launch<TX, TR, kRes, 16>(a, s);
}

template <typename TX>
cudaError_t dispatch_r(const Args& a, int rdtype, cudaStream_t s) {
  if (a.r == nullptr) return dispatch_n<TX, TX, false>(a, s);
  switch (rdtype) {
    case 0: return dispatch_n<TX, float, true>(a, s);
    case 1: return dispatch_n<TX, bf16, true>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [rows, H] at row stride sx and the optional residual r [rows, H] at row
// stride sr (dtype codes 0 f32, 1 bf16; rdtype is read only with r), f32
// w and b [H], out [rows, H] contiguous in the promotion of the two dtypes.
// H a multiple of 8 up to 4096.  Returns a CUDA error code, 0 on success;
// launches nothing for 0 rows.
extern "C" int vln_layer_norm(const void* x, const void* r, const void* w,
                              const void* b, void* out, int xdtype, int rdtype,
                              long long rows, int H, long long sx, long long sr,
                              float eps, void* stream) {
  if (H <= 0 || H > kMaxH || H % kChunk != 0 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  Args a{x, r, static_cast<const float*>(w), static_cast<const float*>(b), out,
         rows, H, sx, sr, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (xdtype) {
    case 0: e = dispatch_r<float>(a, rdtype, s); break;
    case 1: e = dispatch_r<bf16>(a, rdtype, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
