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
// 0.92 MB, about 0.28 us of bytes: below the time of one launch of an
// empty kernel, so latency, not the card's rates, bounds it.
//
// Design. The N*T pool rows go in groups of `rows_per_cta` (1, 2 or 4)
// and D into `cluster` slices (up to 8, one portable thread-block
// cluster): one 256-thread block per (row group, slice), at least 128
// blocks where the shape allows; the serving shape's 32 rows are 16
// groups of 2 x 8 slices (vector_distance.py's `geometry` picks the cut).
// A unit is 8 elements (one 16-byte bf16 row chunk, two 16-byte query
// chunks) where D % 8 == 0 and the pointers are 16-byte aligned, else one
// element. A block walks its slice in tiles of at most one unit a thread,
// two shared-memory buffers deep: while one tile is summed, cp.async
// brings the next, each warp's 32 units of every query of the pass
// (lane-contiguous, through L1) and each thread's unit of every row of the
// group; the staged query values serve every row of the group. For each
// unit a thread takes ||q||^2, ||b||^2 and q . b the same way (unit_dot:
// two FMA chains over the unit's halves, then their sum) and adds
// (||q||^2 + ||b||^2) - 2 q . b to its sum for that (row, query). One
// fixed tree then reduces the sums: a halving warp reduction (each step
// adds the same pairs as a butterfly), the warps in order through shared
// memory, and the slices in rank order, every other block of the cluster
// having sent its sums into rank 0's shared memory with st.async onto
// rank 0's mbarrier (distributed shared memory: only rank 0 waits). The
// result does not depend on scheduling, and for a query equal to a stored
// vector every unit adds exactly 0, so its distance is exactly 0. A batch
// of more than kQChunk queries is walked in passes over the same rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQChunk = 8;              // queries per pass over the rows
constexpr int kMaxCluster = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16_ca(uint32_t dst,
                                              const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// kU bf16 values of a row, upcast to f32 exactly
template <int kU>
__device__ __forceinline__ void unpack(const uint4& raw, float* x) {
  if constexpr (kU == 8) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  } else {
    x[0] = __uint_as_float(raw.x << 16);
  }
}

template <int kU>
__device__ __forceinline__ uint4 load_unit(
    const __nv_bfloat16* __restrict__ row, int u) {
  if constexpr (kU == 8) {
    return reinterpret_cast<const uint4*>(row)[u];
  } else {
    return make_uint4(reinterpret_cast<const unsigned short*>(row)[u], 0u,
                      0u, 0u);
  }
}

// a . b over a unit's kU elements: two FMA chains, over the first and the
// second half of the unit in order, then their sum (one chain of 1).
// ||q||^2, ||b||^2 and q . b all take it, so they round alike.
template <int kU>
__device__ __forceinline__ float unit_dot(const float* a, const float* b) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int k = 0; k < kU / 2; ++k) {
    lo = fmaf(a[k], b[k], lo);
    hi = fmaf(a[kU / 2 + k], b[kU / 2 + k], hi);
  }
  if constexpr (kU == 1) lo = a[0] * b[0];
  return lo + hi;
}

// The warp's sums of kN values (a power of two up to 32) at xor step kO:
// a lane adds its partner's copy of the half of the values it keeps
// (lanes with bit kO set keep the upper half), so the sum of value i ends
// in the lanes whose bits 4, 3, ... spell i; once one value is left the
// steps are plain butterflies. Every value is summed over the same pairs
// as in a butterfly. `index` gathers the lane's value index.
template <int kN, int kO>
__device__ __forceinline__ void reduce_step(float* v, int lane, int& index) {
  if constexpr (kO > 0) {
    if constexpr (kN > 1) {
      const bool upper = lane & kO;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const float lo = v[i], hi = v[i + kN / 2];
        v[i] = (upper ? hi : lo)
               + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, kO);
      }
      index = 2 * index + (upper ? 1 : 0);
      reduce_step<kN / 2, kO / 2>(v, lane, index);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], kO);
      reduce_step<1, kO / 2>(v, lane, index);
    }
  }
}

// the warp's sum of value `index` (returned) of kV values
template <int kV>
__device__ __forceinline__ float warp_reduce(float (&v)[kV], int lane,
                                             int& index) {
  index = 0;
  reduce_step<kV, 16>(v, lane, index);
  return v[0];
}

// Shared memory `qs`: the pass's query values of this tile, query j's
// unit i at [(j * tile_units + i) * kU], copied lane-contiguously by the
// warp whose threads take those units.
template <int kU, int kR, int kQ>
__global__ void __launch_bounds__(kThreads)
l2_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ blk,
          float* __restrict__ out, int nq, int t_rows, int rows, int d,
          int cluster, int slice_units, int tile_units) {
  constexpr int kV = kR * kQ;           // sums a pass: (row, query)
  extern __shared__ __align__(16) float qs[];
  __shared__ float red[kWarps][kV];
  __shared__ float gather[kMaxCluster][kV];   // rank 0's: every slice's
  __shared__ unsigned long long bar;    // rank 0's: the slices' arrivals
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x % cluster;
  const int row0 = (blockIdx.x / cluster) * kR;
  const int nr = min(kR, rows - row0);
  const int u_lo = rank * slice_units;
  const int u_hi = min(d / kU, u_lo + slice_units);
  if (cluster > 1) {
    if (rank == 0 && threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  for (int q0 = 0, pass = 0; q0 < nq; q0 += kQ, ++pass) {
    const int qn = min(kQ, nq - q0);
    const float* qbase = q + static_cast<size_t>(q0) * d;
    if (cluster > 1 && rank == 0 && threadIdx.x == 0) {
      // the other slices' sums of this pass
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_addr(&bar)),
                      "r"(4 * kV * (cluster - 1)) : "memory");
    }
    // per thread and (row, query): ||q||^2 + ||b||^2 - 2 q.b over its units
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.0f;

    // tile t0's loads into shared-memory buffer `buf`, all issued before
    // any is used: this warp's 32 units of every query, lane-contiguous,
    // and (16-byte path) the thread's unit of every row
    const size_t qstride = static_cast<size_t>(min(nq, kQChunk))
                           * tile_units * kU;
    const size_t bstride =
        qstride + (kU == 8 ? static_cast<size_t>(kR) * tile_units * 4 : 0);
    auto stage = [&](int t0, int buf) {
      const int t_hi = min(u_hi, t0 + tile_units);
      const int w0 = t0 + 32 * warp;
      float* base = qs + buf * bstride;
      if (w0 < t_hi) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (j < qn) {
            const float* src = qbase + static_cast<size_t>(j) * d;
            float* dst = base + static_cast<size_t>(j) * tile_units * kU
                         + 32 * warp * kU;
            if constexpr (kU == 8) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = lane + 32 * h;     // float4 of the warp's span
                if (w0 + c / 2 < t_hi) {
                  cp_async16_ca(smem_addr(dst + 4 * c),
                                src + static_cast<size_t>(w0) * 8 + 4 * c);
                }
              }
            } else if (w0 + lane < t_hi) {
              cp_async4(smem_addr(dst + lane), src + w0 + lane);
            }
          }
        }
      }
      if constexpr (kU == 8) {
        const int u = t0 + threadIdx.x;
        if (threadIdx.x < tile_units && u < t_hi) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (r < nr) {
              cp_async16(smem_addr(base + qstride
                                   + (r * tile_units + threadIdx.x) * 4),
                         blk + static_cast<size_t>(row0 + r) * d + 8 * u);
            }
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    // two buffers: the next tile loads while this one is summed
    stage(u_lo, 0);
    for (int t0 = u_lo, buf = 0; t0 < u_hi; t0 += tile_units, buf ^= 1) {
      const bool more = t0 + tile_units < u_hi;
      if (more) {
        stage(t0 + tile_units, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();                // the warp's copies are visible to it
      const int u = t0 + threadIdx.x;
      if (threadIdx.x < tile_units && u < min(u_hi, t0 + tile_units)) {
        uint4 cur[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if constexpr (kU == 8) {
            cur[r] = reinterpret_cast<const uint4*>(
                qs + buf * bstride + qstride)[r * tile_units + threadIdx.x];
          } else if (r < nr) {
            cur[r] = load_unit<kU>(blk + static_cast<size_t>(row0 + r) * d,
                                   u);
          }
        }
        float x[kR][kU], bb[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          unpack<kU>(cur[r], x[r]);
          bb[r] = unit_dot<kU>(x[r], x[r]);
        }
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (j < qn) {
            float y[kU];
            const float* src = qs + buf * bstride
                               + (static_cast<size_t>(j) * tile_units
                                  + threadIdx.x) * kU;
            if constexpr (kU == 8) {
              const float4 a = reinterpret_cast<const float4*>(src)[0];
              const float4 b = reinterpret_cast<const float4*>(src)[1];
              y[0] = a.x; y[1] = a.y; y[2] = a.z; y[3] = a.w;
              y[4] = b.x; y[5] = b.y; y[6] = b.z; y[7] = b.w;
            } else {
              y[0] = src[0];
            }
            const float qq = unit_dot<kU>(y, y);
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              acc[r * kQ + j] += (qq + bb[r]) - 2.0f * unit_dot<kU>(y, x[r]);
            }
          }
        }
      }
      __syncwarp();                // this buffer is rewritten next tile
    }

    // one tree for every sum: the warp's lanes, the warps in order, then
    // the slices in rank order in rank 0's shared memory
    int idx;
    const float ws = warp_reduce<kV>(acc, lane, idx);
    if ((lane & (32 / kV - 1)) == 0) red[warp][idx] = ws;
    __syncthreads();
    if (cluster > 1 && pass == 0) {
      // every block's mbarrier is set up before any slice sends
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    }
    const int i = threadIdx.x;
    if (i < kV) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += red[w][i];
      if (rank == 0) {
        gather[0][i] = v;
      } else {
        uint32_t dst, rbar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                     : "=r"(dst) : "r"(smem_addr(&gather[rank][i])));
        asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                     : "=r"(rbar) : "r"(smem_addr(&bar)));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];"
            :: "r"(dst), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
      }
    }
    if (rank == 0) {
      if (cluster > 1) {
        uint32_t done = 0;
        while (!done) {
          asm volatile(
              "{\n.reg .pred p;\n"
              "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              "selp.u32 %0, 1, 0, p;\n}"
              : "=r"(done) : "r"(smem_addr(&bar)), "r"(pass & 1)
              : "memory");
        }
      }
      __syncthreads();
      const int r = i / kQ;
      const int j = i % kQ;
      if (i < kV && r < nr && j < qn) {
        float v = 0.0f;
        for (int c = 0; c < cluster; ++c) v += gather[c][i];
        const int row = row0 + r;
        out[(static_cast<size_t>(row / t_rows) * nq + q0 + j) * t_rows
            + row % t_rows] = v;
      }
    }
    if (cluster > 1 && q0 + kQ < nq) {
      // rank 0 has read this pass's gather before any slice sends again
      asm volatile("barrier.cluster.arrive.aligned;\n"
                   "barrier.cluster.wait.aligned;" ::: "memory");
    }
  }
}

using L2Kernel = void (*)(const float*, const __nv_bfloat16*, float*, int,
                         int, int, int, int, int, int);

template <int kU, int kR>
L2Kernel pick_q(int kq) {
  return kq == 1   ? &l2_kernel<kU, kR, 1>
         : kq == 2 ? &l2_kernel<kU, kR, 2>
         : kq == 4 ? &l2_kernel<kU, kR, 4>
                   : &l2_kernel<kU, kR, 8>;
}

template <int kU>
L2Kernel pick_r(int kr, int kq) {
  return kr == 1 ? pick_q<kU, 1>(kq)
         : kr == 2 ? pick_q<kU, 2>(kq) : pick_q<kU, 4>(kq);
}

}  // namespace

// q (nq, d) f32, blk (n, t_rows, d) bf16, out (n, nq, t_rows) f32, all
// contiguous. vec != 0 selects 8-element units: d % 8 == 0 and both input
// pointers 16-byte aligned (the wrapper checks). The geometry
// (vector_distance.py's `geometry`): D cut into `cluster` (1, 2, 4 or 8)
// slices of
// `slice_units` units, walked in tiles of `tile_units` (at most one unit a
// thread), the n * t_rows rows in groups of `rows_per_cta` (1, 2 or 4);
// passes of up to 8 queries, the kernel instantiated for the next power of
// two of min(nq, 8); `smem_bytes` of dynamic shared memory hold a tile of
// min(nq, 8) queries and (vec) of the block's rows, two tiles where a
// slice takes more than one. Returns
// cudaGetLastError() after the launch, or the error of the shared-memory
// opt-in or of the launch.
extern "C" int l2_distance_launch(const void* q, const void* blk, void* out,
                                  int n, int nq, int t_rows, int d, int vec,
                                  int cluster, int rows_per_cta,
                                  int slice_units, int tile_units,
                                  int smem_bytes, void* stream) {
  if (n <= 0 || nq <= 0 || t_rows <= 0) return 0;
  const long long rows = static_cast<long long>(n) * t_rows;
  const int units = vec ? d / 8 : d;
  if (rows >= (1LL << 31) || (vec && d % 8) || cluster < 1
      || cluster > kMaxCluster || (cluster & (cluster - 1))
      || (rows_per_cta != 1 && rows_per_cta != 2 && rows_per_cta != 4)
      || tile_units < 1 || tile_units > kThreads || slice_units < 1
      || static_cast<long long>(cluster) * slice_units < units
      || smem_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      (rows + rows_per_cta - 1) / rows_per_cta * cluster;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int kq = nq >= 8 ? 8 : nq > 2 ? 4 : nq;
  const L2Kernel kernel = vec ? pick_r<8>(rows_per_cta, kq)
                              : pick_r<1>(rows_per_cta, kq);
  // load the kernel's module before its first cluster launch (with lazy
  // loading a first launch in clusters beyond 48 KB was refused)
  cudaFuncAttributes fattr;
  cudaError_t err = cudaFuncGetAttributes(&fattr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every call: the default limit is 48 KB less the kernel's static
  // shared memory, and the instantiations share nothing
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(q),
      static_cast<const __nv_bfloat16*>(blk), static_cast<float*>(out), nq,
      t_rows, static_cast<int>(rows), d, cluster, slice_units, tile_units);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vector_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
