// WKV6 recurrence kernel for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by repro_torch/kernels/rwkv6_scan.py).
//
// Replaces the Pallas TPU kernel wkv6 of src/repro/kernels/rwkv6_scan.py:70
// (_wkv_kernel, :26): the time-mix recurrence of every RWKV6 layer on the
// full-sequence forward (prefill, loss evaluation), which
// models/rwkv6.forward runs through kernels.ops.wkv6 once per layer.
//
// What it computes, for r, k, v, w (B, S, H, hs) f32 and u (H, hs) f32,
// into out (B, S, H, hs) f32, from a zero state S (hs x hs) per (b, h):
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * (k_t[i] * v_t[j]))
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// The state update rounds where the plain version (models/rwkv6.wkv_scan,
// eager PyTorch) rounds: k*v, u*kv, S + u*kv, w*S and w*S + kv are each
// rounded to f32 (__fmul_rn / __fadd_rn: no FMA contraction), so the state
// is bit-equal to the plain version's at every step and only the order of
// the 64-term output sum differs. No final state is returned, as in the
// Pallas kernel.
//
// Bound on an H100 SXM: bytes of r, k, v, w and out once (5 * B*S*H*hs * 4)
// against 3.35 TB/s; operations 7 * hs^2 per (b, t, h) (6 in the update and
// sum above plus the sum's add) against 67 TFLOP/s f32 on CUDA cores. At the
// rwkv6-7b prefill shape (B, S, H, hs) = (2, 4096, 64, 64): 671 MB, 0.20 ms
// of bytes; 15.0 GFLOP, 0.22 ms of operations. What sets the pace instead is
// the sequential loop over S: every step waits for the one before it.
//
// Design (simple and right first): column j of S evolves on its own
// (S[:, j] <- w * S[:, j] + k * v_j) and out_t[j] needs only that column,
// so one thread block per (b, h) holds the whole state in registers: four
// neighbouring lanes share a column, each holding hs/4 of its rows (16
// floats at hs = 64), and combine their partial output sums with two
// butterfly shuffles. That is 4*hs threads per block (256 at hs = 64): at
// the path shape 128 blocks of 8 warps, one per SM, instead of the 1-2
// warps a thread-per-column design would give each (b, h). The block walks
// time in chunks of kSteps steps: r, k, w and v of a chunk are staged in
// shared memory (r, k, w with each lane group's rows padded by 4 floats so
// the four 16-byte reads of a warp hit distinct banks), while the next
// chunk's 16-byte global loads are already in flight in registers. Steps
// past S (a ragged last chunk) are loaded as zeros and not computed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParts = 4;  // lanes sharing one state column

template <int HS>
struct Shape {
  static constexpr int kRows = HS / kParts;              // rows per thread
  static constexpr int kThreads = HS * kParts;
  static constexpr int kSteps = HS <= 64 ? 32 : 16;      // steps per chunk
  static constexpr int kPartStride = kRows + 4;          // padded lane group
  static constexpr int kRowStride = kParts * kPartStride;  // padded step row
  static constexpr int kVec = HS / 4;                    // float4 per row
  static constexpr int kLoads = kSteps * kVec / kThreads;  // per thread
  static_assert(kRows % 4 == 0, "hs must be a multiple of 16");
  static_assert(kLoads * kThreads == kSteps * kVec, "whole loads");
};

// one state row of one column: rounds as the plain version does
__device__ __forceinline__ void wkv_row(float rr, float kk, float ww,
                                        float uu, float vj, float& s,
                                        float& acc) {
  const float kv = __fmul_rn(kk, vj);
  const float sk = __fadd_rn(s, __fmul_rn(uu, kv));
  acc = fmaf(rr, sk, acc);
  s = __fadd_rn(__fmul_rn(ww, s), kv);
}

template <int HS>
__global__ void __launch_bounds__(HS * kParts)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ out, int seq,
            int heads) {
  using C = Shape<HS>;
  constexpr int R = C::kRows;
  __shared__ __align__(16) float s_r[C::kSteps * C::kRowStride];
  __shared__ __align__(16) float s_k[C::kSteps * C::kRowStride];
  __shared__ __align__(16) float s_w[C::kSteps * C::kRowStride];
  __shared__ __align__(16) float s_v[C::kSteps * HS];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int j = tid / kParts;   // state column (value index)
  const int p = tid % kParts;   // lane group: rows p*R .. p*R + R - 1

  float uu[R], st[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    uu[m] = u[h * HS + p * R + m];
    st[m] = 0.0f;
  }

  const long long step = static_cast<long long>(heads) * HS;  // t -> t+1
  const long long base = static_cast<long long>(b) * seq * step
                         + static_cast<long long>(h) * HS;      // (b,0,h,0)

  // the next chunk, in flight in registers: kLoads float4 of each array
  float4 pr[C::kLoads], pk[C::kLoads], pw[C::kLoads], pv[C::kLoads];
  auto load = [&](int t0) {
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int e = tid + l * C::kThreads;
      const int t = e / C::kVec;
      const int c = (e - t * C::kVec) * 4;
      if (t0 + t < seq) {
        const long long g = base + (t0 + t) * step + c;
        pr[l] = *reinterpret_cast<const float4*>(r + g);
        pk[l] = *reinterpret_cast<const float4*>(k + g);
        pw[l] = *reinterpret_cast<const float4*>(w + g);
        pv[l] = *reinterpret_cast<const float4*>(v + g);
      } else {
        pr[l] = pk[l] = pw[l] = pv[l] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int e = tid + l * C::kThreads;
      const int t = e / C::kVec;
      const int c = (e - t * C::kVec) * 4;
      const int o = t * C::kRowStride + (c / R) * C::kPartStride + c % R;
      *reinterpret_cast<float4*>(s_r + o) = pr[l];
      *reinterpret_cast<float4*>(s_k + o) = pk[l];
      *reinterpret_cast<float4*>(s_w + o) = pw[l];
      *reinterpret_cast<float4*>(s_v + t * HS + c) = pv[l];
    }
  };

  load(0);
  for (int t0 = 0; t0 < seq; t0 += C::kSteps) {
    __syncthreads();            // the previous chunk is fully consumed
    stage();
    __syncthreads();
    if (t0 + C::kSteps < seq) load(t0 + C::kSteps);
    const int n = min(C::kSteps, seq - t0);
    for (int t = 0; t < n; ++t) {
      const float* sr = s_r + t * C::kRowStride + p * C::kPartStride;
      const float* sk = s_k + t * C::kRowStride + p * C::kPartStride;
      const float* sw = s_w + t * C::kRowStride + p * C::kPartStride;
      const float vj = s_v[t * HS + j];
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < R; m += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(sr + m);
        const float4 k4 = *reinterpret_cast<const float4*>(sk + m);
        const float4 w4 = *reinterpret_cast<const float4*>(sw + m);
        wkv_row(r4.x, k4.x, w4.x, uu[m], vj, st[m], acc);
        wkv_row(r4.y, k4.y, w4.y, uu[m + 1], vj, st[m + 1], acc);
        wkv_row(r4.z, k4.z, w4.z, uu[m + 2], vj, st[m + 2], acc);
        wkv_row(r4.w, k4.w, w4.w, uu[m + 3], vj, st[m + 3], acc);
      }
      // the four lane groups of column j, in one fixed order
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p == 0) out[base + (t0 + t) * step + j] = acc;
    }
  }
}

template <int HS>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* out, int batch, int seq, int heads,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(batch) * heads);
  wkv6_kernel<HS><<<grid, Shape<HS>::kThreads, 0, s>>>(r, k, v, w, u, out,
                                                       seq, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, out (batch, seq, heads, hs) f32 and u (heads, hs) f32, all
// contiguous and 16-byte aligned (the wrapper checks); hs in {16, 32, 64,
// 128}. Returns cudaGetLastError() after the launch.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* out,
                           int batch, int seq, int heads, int hs,
                           void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(batch) * heads >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  switch (hs) {
    case 16: return launch<16>(rf, kf, vf, wf, uf, of, batch, seq, heads, s);
    case 32: return launch<32>(rf, kf, vf, wf, uf, of, batch, seq, heads, s);
    case 64: return launch<64>(rf, kf, vf, wf, uf, of, batch, seq, heads, s);
    case 128:
      return launch<128>(rf, kf, vf, wf, uf, of, batch, seq, heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
