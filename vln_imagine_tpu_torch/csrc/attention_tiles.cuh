// Tiles and tensor-core primitives shared by the attention forward
// (attention_fwd.cu) and backward (attention_bwd.cu) kernels.
//
// Both kernels work on blocks of kWarps warps that own kRows rows (query
// rows or keys, the mma's M) and deal the other axis out to the warps in
// sub-tiles of kSub columns.  Operands are staged into shared memory by
// cp.async in rows padded by 16 bytes, so the eight rows of each 8x8 matrix
// that ldmatrix reads fall in distinct banks.  bf16 products run on the
// tensor cores (mma.sync.m16n8k16, f32 accumulate); f32 products run as
// CUDA-core FMAs (no TF32) in the same tiles and fragment layout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace vln {

constexpr int kWarps = 4;      // warps per block
constexpr int kRows = 16;      // rows a block owns (the mma's M)
constexpr int kSub = 16;       // columns of one register sub-tile
constexpr int kThreads = kWarps * 32;
constexpr int kNT = kSub / 8;  // 8-column mma tiles in a sub-tile

// rows staged in shared memory at a time, at most
__host__ __device__ constexpr int chunk_rows(int D) { return D <= 64 ? 128 : 64; }
// padded row of a staged [rows, D] tile and of a per-warp [16, kSub]
// buffer, in elements: 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / static_cast<int>(sizeof(T)); }
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// rows of an L-long axis staged at a time: all of them, rounded up to a
// sub-tile, up to one chunk
inline int staged_rows(int L, int D) {
  const int all = round_up(L, kSub);
  return all < chunk_rows(D) ? all : chunk_rows(D);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed copy groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp products on shared-memory tiles, results in the mma's accumulator
// layout: lane (g = lane / 4, t = lane % 4) holds c[n][0..1] at row g,
// columns 8n + 2t, 8n + 2t + 1, and c[n][2..3] at row g + 8.
//
// gemm_nt: c[16, 8NT] += A[16, K] B[8NT, K]^T  (both K-contiguous)
template <typename T, int K, int NT>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const T* A, int lda,
                                        const T* B, int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float b0 = B[(8 * n + 2 * t) * ldb + k];
        const float b1 = B[(8 * n + 2 * t + 1) * ldb + k];
        c[n][0] = fmaf(a0, b0, c[n][0]);
        c[n][1] = fmaf(a0, b1, c[n][1]);
        c[n][2] = fmaf(a1, b0, c[n][2]);
        c[n][3] = fmaf(a1, b1, c[n][3]);
      }
    }
  } else {
    static_assert(NT % 2 == 0, "pairs of 8-column tiles");
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, A + (lane & 15) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];
        ldsm_x4(b, B + (8 * n + (lane & 7) + ((lane >> 4) << 3)) * ldb + k0 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(c[n], a, b[0], b[1]);
        mma_bf16(c[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// gemm_nn: c[16, 8NT] += A[16, K] B[K, 8NT]  (A K-contiguous, B N-contiguous)
template <typename T, int K, int NT>
__device__ __forceinline__ void gemm_nn(float (&c)[NT][4], const T* A, int lda,
                                        const T* B, int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float b0 = B[k * ldb + 8 * n + 2 * t];
        const float b1 = B[k * ldb + 8 * n + 2 * t + 1];
        c[n][0] = fmaf(a0, b0, c[n][0]);
        c[n][1] = fmaf(a0, b1, c[n][1]);
        c[n][2] = fmaf(a1, b0, c[n][2]);
        c[n][3] = fmaf(a1, b1, c[n][3]);
      }
    }
  } else {
    static_assert(NT % 2 == 0, "pairs of 8-column tiles");
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, A + (lane & 15) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, B + (k0 + (lane & 15)) * ldb + 8 * n + (lane >> 4) * 8);
        mma_bf16(c[n], a, b[0], b[1]);
        mma_bf16(c[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// two adjacent values of one row, rounded to T
template <typename T>
__device__ __forceinline__ void store2(T* dst, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
}

// an accumulator [16, 8NT] into a row-major [16, ld] tile
template <typename T, int NT>
__device__ __forceinline__ void store_acc(T* dst, int ld, const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    store2(dst + g * ld + 8 * n + 2 * t, c[n][0], c[n][1]);
    store2(dst + (g + 8) * ld + 8 * n + 2 * t, c[n][2], c[n][3]);
  }
}

// rows [row0, row0 + n) of a strided [L, D] slice into a [n, D + pad] tile;
// rows >= L are zero-filled (0 * anything stays finite in the products)
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* src, long long row_stride,
                                      int row0, int L, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = D + pad<T>();
  for (int idx = threadIdx.x; idx < n * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    const int row = row0 + r;
    const bool valid = row < L;
    cp_async16(dst + r * LD + c, src + (valid ? row : 0) * row_stride + c, valid);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace vln
