// Batched squared-L2 distance kernel for Hopper (sm_90a), bound through a
// plain C interface (loaded with ctypes by
// repro_torch/kernels/vector_distance.py).
//
// Replaces the Pallas TPU kernel l2_distance of
// src/repro/kernels/vector_distance.py:50 (_l2_kernel, :30): the compute
// half of the vector-search tenant's walk.
//
// What it computes, for f32 queries q (Q, D) and bf16 pool blocks b
// (N, T, D), into f32 out (N, Q, T):
//   out[n, q, t] = ||q||^2 + ||b[n, t]||^2 - 2 q . b[n, t]
// with the bf16 values upcast to f32 in registers and every product and
// sum taken in f32 FMAs: no tensor cores and no TF32, because the
// reference takes the dot in f32 and a TF32 product would miss its
// tolerance (rtol 1e-4, atol 1e-3 against the direct sum of squares).
//
// Bound on an H100 SXM: bytes N*T*D*2 + Q*D*4 + N*Q*T*4 against 3.35 TB/s,
// operations ~2*N*T*D*(Q+1) against 67 TFLOP/s f32 (each byte of a block
// feeds Q+1 FMAs). At the serving shape (Q=4, N=2, T=16, D=11520) that is
// 0.92 MB, about 0.28 us of bytes: the launch, not the card, bounds it.
//
// Design (simple and right first): one thread block of 256 threads per
// block row (n, t), grid N*T, so even the serving shape's two gathered
// blocks spread over 32 SMs. Each thread strides over D (eight bf16
// values per 16-byte load where D is a multiple of 8 and the pointers are
// 16-byte aligned, one value at a time otherwise) and keeps ||b||^2 plus,
// for up to kQChunk queries at a time, q . b and ||q||^2 in registers; a
// larger query batch is walked in chunks over the same row (the re-read
// comes from L1/L2). ||q||^2 is recomputed per row from the query values
// the dot product loads anyway: FMAs, no extra bytes, and it follows
// exactly the FMA sequence and reduction tree of ||b||^2, so a query equal
// to a stored vector gives exactly 0. Warp shuffles, then one
// shared-memory hop in a fixed order, reduce the threads: the result does
// not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQChunk = 8;             // queries per pass over a row
constexpr int kVals = 2 * kQChunk + 1;  // ||b||^2, q.b and ||q||^2 sums

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same, order-independent value
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

__device__ __forceinline__ void unpack8(uint4 raw, float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
l2_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ blk,
          float* __restrict__ out, int nq, int t_rows, int d) {
  __shared__ float red[kWarps][kVals];
  __shared__ float fin[kVals];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t r = blockIdx.x;                 // row n * t_rows + t
  const __nv_bfloat16* row = blk + r * d;
  const size_t n = r / t_rows;
  const size_t t = r % t_rows;

  for (int q0 = 0; q0 < nq; q0 += kQChunk) {
    const int qn = min(kQChunk, nq - q0);
    const float* qbase = q + static_cast<size_t>(q0) * d;
    float bb = 0.0f;
    float dot[kQChunk];
    float qq[kQChunk];
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) dot[j] = qq[j] = 0.0f;
    if (kVec) {
      for (int c = threadIdx.x; c < d / 8; c += kThreads) {
        float x[8];
        unpack8(reinterpret_cast<const uint4*>(row)[c], x);
#pragma unroll
        for (int k = 0; k < 8; ++k) bb = fmaf(x[k], x[k], bb);
#pragma unroll
        for (int j = 0; j < kQChunk; ++j) {
          if (j < qn) {
            float y[8];
            load8(qbase + static_cast<size_t>(j) * d + 8 * c, y);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              dot[j] = fmaf(y[k], x[k], dot[j]);
              qq[j] = fmaf(y[k], y[k], qq[j]);
            }
          }
        }
      }
    } else {
      for (int e = threadIdx.x; e < d; e += kThreads) {
        const float x = __bfloat162float(row[e]);
        bb = fmaf(x, x, bb);
#pragma unroll
        for (int j = 0; j < kQChunk; ++j) {
          if (j < qn) {
            const float y = qbase[static_cast<size_t>(j) * d + e];
            dot[j] = fmaf(y, x, dot[j]);
            qq[j] = fmaf(y, y, qq[j]);
          }
        }
      }
    }
    // one reduction tree for every sum: lanes, then warps in order
    bb = warp_sum(bb);
    if (lane == 0) red[warp][0] = bb;
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) {
      if (j < qn) {
        const float sd = warp_sum(dot[j]);
        const float sq = warp_sum(qq[j]);
        if (lane == 0) {
          red[warp][1 + j] = sd;
          red[warp][1 + kQChunk + j] = sq;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < kVals) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
      fin[threadIdx.x] = v;
    }
    __syncthreads();
    if (threadIdx.x < qn) {
      const int j = threadIdx.x;
      out[(n * nq + q0 + j) * t_rows + t] =
          fin[1 + kQChunk + j] + fin[0] - 2.0f * fin[1 + j];
    }
    __syncthreads();
  }
}

}  // namespace

// q (nq, d) f32, blk (n, t_rows, d) bf16, out (n, nq, t_rows) f32, all
// contiguous. vec != 0 selects the 16-byte-load path: d % 8 == 0 and both
// input pointers 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int l2_distance_launch(const void* q, const void* blk, void* out,
                                  int n, int nq, int t_rows, int d, int vec,
                                  void* stream) {
  if (n <= 0 || nq <= 0 || t_rows <= 0) return 0;
  const long long rows = static_cast<long long>(n) * t_rows;
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const __nv_bfloat16* bf = static_cast<const __nv_bfloat16*>(blk);
  float* of = static_cast<float*>(out);
  if (vec) {
    l2_kernel<true><<<grid, kThreads, 0, s>>>(qf, bf, of, nq, t_rows, d);
  } else {
    l2_kernel<false><<<grid, kThreads, 0, s>>>(qf, bf, of, nq, t_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vector_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
