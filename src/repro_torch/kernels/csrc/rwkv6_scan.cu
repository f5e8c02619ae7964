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
// evaluated in the factored form
//   out_t[j] = sum_i r_t[i] * S[i][j] + v_t[j] * c_t,
//   c_t = sum_i r_t[i] * u[i] * k_t[i]
// (the bonus term does not depend on the column). The state update rounds
// where the plain version (models/rwkv6.wkv_scan, eager PyTorch) rounds:
// k*v, w*S and w*S + kv are each rounded to f32 (__fmul_rn / __fadd_rn, no
// FMA contraction), so the state is bit-equal to the plain version's at
// every step; the output differs only by the order of its sums and by the
// factoring. No final state is returned, as in the Pallas kernel.
//
// What bounds it on an H100 SXM: bytes of r, k, v, w and out once
// (5 * B*S*H*hs * 4) against 3.35 TB/s; operations 5 * hs^2 per (b, t, h)
// (r*S and its sum, k*v, w*S, + kv) against 67 TFLOP/s f32 on CUDA cores.
// At the rwkv6-7b prefill shape (B, S, H, hs) = (2, 4096, 64, 64): 671 MB,
// 0.20 ms of bytes; 10.7 GFLOP, 0.16 ms of operations. What sets the pace
// instead is the sequential loop over S: every step waits for the one
// before it, so the time is steps x (instructions a step issues on one SM
// + the latency they do not hide).
//
// Design: column j of S evolves on its own (S[:, j] <- w * S[:, j] + k *
// v_j) and out_t[j] needs only that column, so one thread block per (b, h)
// holds the whole state in registers, each thread a block of kRows rows x
// kCols columns (4 x 4 at hs = 64: 256 threads, 8 warps; at the path shape
// 128 blocks, one per SM). Each element costs four FP instructions a step
// (r*S into the column's partial sum, k*v, w*S, + kv), not six: the bonus
// dot c_t is taken once per step for the whole block, while a chunk is
// staged, from the registers its loads land in. So a step issues at least
// 4 hs^2 / 32 = 512 warp instructions of FP on one SM (128 cycles), and
// that, not bytes or latency, is what bounds the kernel on this card.
// What the layout does about the rest: r, k and w are read by every
// column, 12 hs^2 bytes a step if each thread read its own; here each
// read of r_i, k_i, w_i serves a thread's 4 columns, and the lanes of a
// warp share a few rows, so every read is a 4-byte broadcast (one
// wavefront; on an H100 measured faster than 16-byte broadcasts, which
// cost more than one). v and a thread's partial sums move as one 16-byte access.
// The row groups' partial output sums go to shared memory each step and
// are summed, in one fixed order, when the chunk is stored: no shuffles
// in the step. The block walks time in chunks of kSteps steps: r, k, w
// and v of a chunk are staged in shared memory while the next chunk's
// 16-byte global loads are already in flight in registers; a chunk's
// outputs leave 16 bytes a thread. Steps past S (a ragged last chunk) are
// loaded as zeros and neither computed nor stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HS>
struct Shape {
  // thread (p, q) holds kRows rows (lane group p) of kCols neighbouring
  // columns (column group q) of the state
  static constexpr int kRows = HS == 128 ? 8 : 4;
  static constexpr int kCols = HS == 16 ? 2 : 4;
  static constexpr int kColGroups = HS / kCols;          // lanes a group
  static constexpr int kParts = HS / kRows;              // lane groups
  static constexpr int kThreads = kParts * kColGroups;   // 32 to 512
  static constexpr int kSteps = HS == 128 ? 16 : 32;     // steps per chunk
  static constexpr int kVec = HS / 4;                    // float4 per row
  static constexpr int kLoads = kSteps * kVec / kThreads;  // per thread
  // s_r, s_k, s_w, s_v [kSteps][HS], the lane groups' partial output sums
  // [kParts][kSteps][HS] and the bonus dots c [2][kSteps] (two chunks)
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kSteps) * HS * (4 + kParts)
                       + 2 * kSteps);
  static_assert(kLoads >= 1 && kLoads * kThreads == kSteps * kVec,
                "whole loads");
  static_assert(kVec <= 32 && kThreads % 32 == 0, "row sums within a warp");
};

// N floats moved as one 8- or 16-byte access
template <int N>
struct VecT;
template <>
struct VecT<2> {
  using type = float2;
};
template <>
struct VecT<4> {
  using type = float4;
};

// a 4-byte shared-memory read; every lane of a lane group reads the same
// address, so a warp's read is a broadcast of one wavefront (on an H100
// measured faster than 16-byte broadcasts, which the compiler would
// otherwise merge these into)
__device__ __forceinline__ float lds(const float* p) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return x;
}

// one state element: out's partial sum reads the state before the
// update; the update rounds as the plain version does
__device__ __forceinline__ void wkv_elem(float rr, float kk, float ww,
                                         float vj, float& s, float& acc) {
  acc = fmaf(rr, s, acc);
  s = __fadd_rn(__fmul_rn(ww, s), __fmul_rn(kk, vj));
}

template <int HS>
__global__ void __launch_bounds__(Shape<HS>::kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ out, int seq,
            int heads) {
  using C = Shape<HS>;
  constexpr int R = C::kRows;
  constexpr int NC = C::kCols;
  constexpr int kChunk = C::kSteps * HS;
  extern __shared__ float4 smem4[];
  float* s_r = reinterpret_cast<float*>(smem4);   // [kSteps][HS]
  float* s_k = s_r + kChunk;
  float* s_w = s_k + kChunk;
  float* s_v = s_w + kChunk;
  float* s_part = s_v + kChunk;                   // [kParts][kSteps][HS]
  float* s_c = s_part + C::kParts * kChunk;       // [2][kSteps]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int j0 = (tid % C::kColGroups) * NC;  // columns j0 .. j0 + NC - 1
  const int p = tid / C::kColGroups;          // rows p*R .. p*R + R - 1

  float st[R][NC];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c) st[m][c] = 0.0f;

  const long long step = static_cast<long long>(heads) * HS;  // t -> t+1
  const long long base = static_cast<long long>(b) * seq * step
                         + static_cast<long long>(h) * HS;      // (b,0,h,0)

  // every load of this thread covers the same four columns c4 .. c4 + 3
  const int c4 = (tid % C::kVec) * 4;
  const float* uh = u + h * HS + c4;
  const float4 u4 = make_float4(uh[0], uh[1], uh[2], uh[3]);

  // the next chunk, in flight in registers: kLoads float4 of each array
  float4 pr[C::kLoads], pk[C::kLoads], pw[C::kLoads], pv[C::kLoads];
  auto load = [&](int t0) {
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int t = (tid + l * C::kThreads) / C::kVec;
      if (t0 + t < seq) {
        const long long g = base + (t0 + t) * step + c4;
        pr[l] = *reinterpret_cast<const float4*>(r + g);
        pk[l] = *reinterpret_cast<const float4*>(k + g);
        pw[l] = *reinterpret_cast<const float4*>(w + g);
        pv[l] = *reinterpret_cast<const float4*>(v + g);
      } else {
        pr[l] = pk[l] = pw[l] = pv[l] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  // the loaded chunk into shared memory, with each step's bonus dot
  // c_t = sum_i r_i u_i k_i summed over the kVec lanes holding step t
  auto stage = [&](float* c_buf) {
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int t = (tid + l * C::kThreads) / C::kVec;
      *reinterpret_cast<float4*>(s_r + t * HS + c4) = pr[l];
      *reinterpret_cast<float4*>(s_k + t * HS + c4) = pk[l];
      *reinterpret_cast<float4*>(s_w + t * HS + c4) = pw[l];
      *reinterpret_cast<float4*>(s_v + t * HS + c4) = pv[l];
      float c = pr[l].x * u4.x * pk[l].x;
      c = fmaf(pr[l].y * u4.y, pk[l].y, c);
      c = fmaf(pr[l].z * u4.z, pk[l].z, c);
      c = fmaf(pr[l].w * u4.w, pk[l].w, c);
#pragma unroll
      for (int off = 1; off < C::kVec; off <<= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      if (c4 == 0) c_buf[t] = c;
    }
  };
  // a finished chunk's outputs: the lane groups' partial sums in one
  // fixed order plus v_j c_t, 16 bytes a thread (before stage() replaces
  // s_v: each thread reads and then rewrites the same four columns)
  auto store = [&](int t0, const float* c_buf) {
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int t = (tid + l * C::kThreads) / C::kVec;
      float4 o = *reinterpret_cast<const float4*>(s_part + t * HS + c4);
#pragma unroll
      for (int q = 1; q < C::kParts; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(
            s_part + q * kChunk + t * HS + c4);
        o.x += a.x;
        o.y += a.y;
        o.z += a.z;
        o.w += a.w;
      }
      const float4 vv = *reinterpret_cast<const float4*>(s_v + t * HS + c4);
      const float c = c_buf[t];
      if (t0 + t < seq) {
        *reinterpret_cast<float4*>(out + base + (t0 + t) * step + c4) =
            make_float4(fmaf(vv.x, c, o.x), fmaf(vv.y, c, o.y),
                        fmaf(vv.z, c, o.z), fmaf(vv.w, c, o.w));
      }
    }
  };

  load(0);
  int chunk = 0;
  for (int t0 = 0; t0 < seq; t0 += C::kSteps, ++chunk) {
    float* c_buf = s_c + (chunk & 1) * C::kSteps;
    __syncthreads();            // the previous chunk is fully consumed
    if (t0 > 0) store(t0 - C::kSteps, s_c + ((chunk - 1) & 1) * C::kSteps);
    stage(c_buf);
    __syncthreads();
    if (t0 + C::kSteps < seq) load(t0 + C::kSteps);
    const int n = min(C::kSteps, seq - t0);
    const float* sr = s_r + p * R;
    const float* sk = s_k + p * R;
    const float* sw = s_w + p * R;
    float* sp = s_part + p * kChunk + j0;
    for (int t = 0; t < n; ++t) {
      // this thread's NC values of v, and its partial sums, move as one
      // 8- or 16-byte access
      using V = typename VecT<NC>::type;
      const V v_raw = *reinterpret_cast<const V*>(s_v + t * HS + j0);
      const float* vv = reinterpret_cast<const float*>(&v_raw);
      V acc_raw;
      float* acc = reinterpret_cast<float*>(&acc_raw);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float rr = lds(sr + t * HS + m);
        const float kk = lds(sk + t * HS + m);
        const float ww = lds(sw + t * HS + m);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wkv_elem(rr, kk, ww, vv[c], st[m][c], acc[c]);
      }
      *reinterpret_cast<V*>(sp + t * HS) = acc_raw;
    }
  }
  __syncthreads();
  store(((seq - 1) / C::kSteps) * C::kSteps, s_c + ((chunk - 1) & 1)
                                                   * C::kSteps);
}

template <int HS>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* out, int batch, int seq, int heads,
           cudaStream_t s) {
  using C = Shape<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * heads);
  wkv6_kernel<HS><<<grid, C::kThreads, C::kSmem, s>>>(r, k, v, w, u, out,
                                                      seq, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, out (batch, seq, heads, hs) f32 and u (heads, hs) f32, all
// contiguous and 16-byte aligned (the wrapper checks); hs in {16, 32, 64,
// 128}. Returns cudaGetLastError() after the launch, or the error of the
// shared-memory opt-in.
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

// ---------------------------------------------------------------------------
// The backward: the gradient of the recurrence above (wkv6_backward_launch)
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the Pallas wkv6 has no backward, and the JAX
// package trains RWKV6 through the plain scan (models/rwkv6.wkv_scan),
// which jax.grad differentiates. The port's RWKV6 loss runs the kernel
// above on the card, so its autograd Function (kernels/ops.py) needs this
// backward for the gradient to reach r, k, v, w and u.
//
// What it computes, from dout (B, S, H, hs) f32, with S_t the state after
// step t (S_{-1} = 0) and G_t = dL/dS_t (G_{S-1} = 0,
// G_{t-1} = w_t (.) G_t + r_t dout_t^T):
//   dr_t[i] = sum_j dout_t[j] S_{t-1}[i][j] + u_i k_t[i] (v_t . dout_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]        + u_i r_t[i] (v_t . dout_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]        + dout_t[j] sum_i r_t[i] u_i k_t[i]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dout_t)
// into dr, dk, dv, dw (B, S, H, hs) and du_part (B, H, hs), the partial of
// du per (b, h), which the wrapper sums over b (fixed order, no atomics).
// kernels/ref.py::wkv6_backward is the same algorithm in plain PyTorch.
//
// Design: one launch, one thread block per (b, h), the forward's layout
// (each thread kRows rows x kCols columns of the hs x hs state, in
// registers). dw needs S_{t-1} and G_t together, and they run in opposite
// directions of time; S_{t-1} is never rebuilt from S_t by dividing by
// w_t, which reaches 0 in f32 (w = exp(-exp(.))). Instead:
//   pass 1, forward in time: the state recomputed from zero with the
//     forward's exact rounding, dr emitted, and the state at the start of
//     every chunk of kBwdSteps steps stored to ckpt (B*H, ceil(S/kBwdSteps),
//     hs*hs);
//   pass 2, backward in time, carrying G: each chunk's states recomputed
//     from its checkpoint (bit-equal to pass 1's) into hist (B*H,
//     kBwdSteps, hs*hs), a per-block scratch that stays in L2 (32 MB at the
//     rwkv6-7b shape), then read back newest first to emit dk, dv, dw.
// Sums over a row (dr, dk, dw: over j) stay within a warp: a row's kCols
// column groups are neighbouring lanes, summed with xor shuffles. Sums over
// a column (dv: over i) cross the row groups' warps: each writes its partial
// to shared memory and the chunk's store adds them in one fixed order. The
// bonus terms use the per-step dots v_t . dout_t and sum_i r_t u_t k_t,
// taken while a chunk is staged.
//
// What bounds it on an H100 SXM: bytes of r, k, v, w, dout read and dr, dk,
// dv, dw written once (9 * B*S*H*hs * 4: 1.21 GB, 0.36 ms at the rwkv6-7b
// shape), against f32 operations of 12 hs^2 a (b, t, h) as designed (pass 1:
// dout*S and the 3-operation update; pass 2: the update again, G*v, G*k,
// G*S and the 2-operation G update: 25.8 GFLOP, 0.39 ms at 67 TFLOP/s). As
// in the forward, the sequential walk over time sets the pace, twice here.

namespace {

template <int HS>
struct BwdShape {
  static constexpr int kRows = Shape<HS>::kRows;
  static constexpr int kCols = Shape<HS>::kCols;
  static constexpr int kColGroups = HS / kCols;          // lanes of a row
  static constexpr int kParts = HS / kRows;              // row groups
  static constexpr int kThreads = kParts * kColGroups;
  static constexpr int kSteps = 16;                      // chunk, checkpoint
  static constexpr int kVec = HS / 4;                    // float4 per row
  static constexpr int kLoads = kSteps * kVec / kThreads;
  static constexpr int kChunk = kSteps * HS;
  // s_r, s_k, s_v, s_w, s_d [kSteps][HS]; column partials
  // [kParts][kSteps][HS]; two row outputs [kSteps][HS]; vd and c [kSteps]
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kChunk) * (7 + kParts)
                       + 2 * kSteps);
  static_assert(kLoads >= 1 && kLoads * kThreads == kSteps * kVec,
                "whole loads");
  static_assert(kColGroups <= 32 && 32 % kColGroups == 0,
                "a row's lanes within a warp");
  static_assert(kThreads % 32 == 0 && kVec <= 32, "whole warps");
  static_assert(kParts * kChunk >= 4 * kThreads, "du exchange fits");
};

// the sum over a row's kColGroups neighbouring lanes (every lane of the
// warp takes part; each lane of the group gets the sum)
template <int NG>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = NG / 2; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HS>
__global__ void __launch_bounds__(BwdShape<HS>::kThreads)
wkv6_backward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ dout, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ckpt, float* __restrict__ hist,
                     int seq, int heads) {
  using C = BwdShape<HS>;
  constexpr int R = C::kRows;
  constexpr int NC = C::kCols;
  constexpr int T = C::kSteps;
  constexpr int kChunk = C::kChunk;
  constexpr int kState = HS * HS;
  extern __shared__ float4 smem4[];
  float* s_r = reinterpret_cast<float*>(smem4);   // [T][HS]
  float* s_k = s_r + kChunk;
  float* s_v = s_k + kChunk;
  float* s_w = s_v + kChunk;
  float* s_d = s_w + kChunk;
  float* s_part = s_d + kChunk;                   // [kParts][T][HS]
  float* s_o1 = s_part + C::kParts * kChunk;      // [T][HS]: dr, or dk
  float* s_o2 = s_o1 + kChunk;                    // [T][HS]: dw
  float* s_vd = s_o2 + kChunk;                    // [T]: v_t . dout_t
  float* s_c = s_vd + T;                          // [T]: sum_i r u k

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int j0 = (tid % C::kColGroups) * NC;  // columns j0 .. j0 + NC - 1
  const int i0 = (tid / C::kColGroups) * R;   // rows i0 .. i0 + R - 1
  const int p = tid / C::kColGroups;
  const bool row_lead = tid % C::kColGroups == 0;

  const long long step = static_cast<long long>(heads) * HS;  // t -> t+1
  const long long base = static_cast<long long>(b) * seq * step
                         + static_cast<long long>(h) * HS;      // (b,0,h,0)
  const int nchunks = (seq + T - 1) / T;
  // this thread's element e = m * NC + c of a stored state sits at
  // [e * kThreads + tid]: every store and load of a state is coalesced
  float* my_ckpt = ckpt + static_cast<long long>(bh) * nchunks * kState;
  float* my_hist = hist + static_cast<long long>(bh) * T * kState;

  // every staged load of this thread covers the columns c4 .. c4 + 3
  const int c4 = (tid % C::kVec) * 4;
  const float* uh = u + h * HS + c4;
  const float4 u4 = make_float4(uh[0], uh[1], uh[2], uh[3]);

  // a chunk of r, k, v, w, dout into shared memory, zeros past seq, with
  // the per-step dots summed over the kVec lanes that hold step t
  auto stage = [&](int t0) {
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int t = (tid + l * C::kThreads) / C::kVec;
      float4 a_r, a_k, a_v, a_w, a_d;
      if (t0 + t < seq) {
        const long long g = base + (t0 + t) * step + c4;
        a_r = *reinterpret_cast<const float4*>(r + g);
        a_k = *reinterpret_cast<const float4*>(k + g);
        a_v = *reinterpret_cast<const float4*>(v + g);
        a_w = *reinterpret_cast<const float4*>(w + g);
        a_d = *reinterpret_cast<const float4*>(dout + g);
      } else {
        a_r = a_k = a_v = a_w = a_d = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      *reinterpret_cast<float4*>(s_r + t * HS + c4) = a_r;
      *reinterpret_cast<float4*>(s_k + t * HS + c4) = a_k;
      *reinterpret_cast<float4*>(s_v + t * HS + c4) = a_v;
      *reinterpret_cast<float4*>(s_w + t * HS + c4) = a_w;
      *reinterpret_cast<float4*>(s_d + t * HS + c4) = a_d;
      float c = a_r.x * u4.x * a_k.x;
      c = fmaf(a_r.y * u4.y, a_k.y, c);
      c = fmaf(a_r.z * u4.z, a_k.z, c);
      c = fmaf(a_r.w * u4.w, a_k.w, c);
      float vd = a_v.x * a_d.x;
      vd = fmaf(a_v.y, a_d.y, vd);
      vd = fmaf(a_v.z, a_d.z, vd);
      vd = fmaf(a_v.w, a_d.w, vd);
#pragma unroll
      for (int off = 1; off < C::kVec; off <<= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, off);
        vd += __shfl_xor_sync(0xffffffffu, vd, off);
      }
      if (c4 == 0) {
        s_c[t] = c;
        s_vd[t] = vd;
      }
    }
  };

  // ---- pass 1: forward in time -------------------------------------------
  float st[R][NC];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c) st[m][c] = 0.0f;

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int t0 = chunk * T;
    __syncthreads();            // the previous chunk is fully consumed
    stage(t0);
    float* slot = my_ckpt + static_cast<long long>(chunk) * kState;
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        slot[(m * NC + c) * C::kThreads + tid] = st[m][c];
    __syncthreads();
    const int n = min(T, seq - t0);
    for (int t = 0; t < n; ++t) {
      float vv[NC], dd[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        vv[c] = s_v[t * HS + j0 + c];
        dd[c] = s_d[t * HS + j0 + c];
      }
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float kk = s_k[t * HS + i0 + m];
        const float ww = s_w[t * HS + i0 + m];
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc = fmaf(dd[c], st[m][c], acc);
        acc = row_sum<C::kColGroups>(acc);
        if (row_lead) s_o1[t * HS + i0 + m] = acc;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          st[m][c] = __fadd_rn(__fmul_rn(ww, st[m][c]), __fmul_rn(kk, vv[c]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int t = (tid + l * C::kThreads) / C::kVec;
      if (t0 + t < seq) {
        const float4 o = *reinterpret_cast<const float4*>(s_o1 + t * HS + c4);
        const float4 kk = *reinterpret_cast<const float4*>(s_k + t * HS + c4);
        const float vd = s_vd[t];
        *reinterpret_cast<float4*>(dr + base + (t0 + t) * step + c4) =
            make_float4(fmaf(u4.x * kk.x, vd, o.x), fmaf(u4.y * kk.y, vd, o.y),
                        fmaf(u4.z * kk.z, vd, o.z), fmaf(u4.w * kk.w, vd, o.w));
      }
    }
  }

  // ---- pass 2: backward in time, carrying G ------------------------------
  float g[R][NC];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c) g[m][c] = 0.0f;
  float4 du4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int chunk = nchunks - 1; chunk >= 0; --chunk) {
    const int t0 = chunk * T;
    const int n = min(T, seq - t0);
    __syncthreads();
    stage(t0);
    // the chunk's states S_{t0-1} .. S_{t0+n-2}, recomputed from its
    // checkpoint into hist (this thread writes and reads only its own
    // elements: no barrier between)
    const float* slot = my_ckpt + static_cast<long long>(chunk) * kState;
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        st[m][c] = slot[(m * NC + c) * C::kThreads + tid];
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float* hs_t = my_hist + static_cast<long long>(t) * kState;
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = s_v[t * HS + j0 + c];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float kk = s_k[t * HS + i0 + m];
        const float ww = s_w[t * HS + i0 + m];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          hs_t[(m * NC + c) * C::kThreads + tid] = st[m][c];
          st[m][c] = __fadd_rn(__fmul_rn(ww, st[m][c]), __fmul_rn(kk, vv[c]));
        }
      }
    }
    for (int t = n - 1; t >= 0; --t) {
      const float* hs_t = my_hist + static_cast<long long>(t) * kState;
      float vv[NC], dd[NC], dvp[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        vv[c] = s_v[t * HS + j0 + c];
        dd[c] = s_d[t * HS + j0 + c];
        dvp[c] = 0.0f;
      }
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float rr = s_r[t * HS + i0 + m];
        const float kk = s_k[t * HS + i0 + m];
        const float ww = s_w[t * HS + i0 + m];
        float dkr = 0.0f, dwr = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float sp = hs_t[(m * NC + c) * C::kThreads + tid];
          dkr = fmaf(g[m][c], vv[c], dkr);
          dwr = fmaf(g[m][c], sp, dwr);
          dvp[c] = fmaf(g[m][c], kk, dvp[c]);
          g[m][c] = fmaf(rr, dd[c], ww * g[m][c]);
        }
        dkr = row_sum<C::kColGroups>(dkr);
        dwr = row_sum<C::kColGroups>(dwr);
        if (row_lead) {
          s_o1[t * HS + i0 + m] = dkr;
          s_o2[t * HS + i0 + m] = dwr;
        }
      }
      float* sp_out = s_part + p * kChunk + t * HS + j0;
#pragma unroll
      for (int c = 0; c < NC; ++c) sp_out[c] = dvp[c];
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < C::kLoads; ++l) {
      const int t = (tid + l * C::kThreads) / C::kVec;
      if (t0 + t < seq) {
        const long long gi = base + (t0 + t) * step + c4;
        const int si = t * HS + c4;
        const float4 o1 = *reinterpret_cast<const float4*>(s_o1 + si);
        const float4 rr = *reinterpret_cast<const float4*>(s_r + si);
        const float4 kk = *reinterpret_cast<const float4*>(s_k + si);
        const float4 dd = *reinterpret_cast<const float4*>(s_d + si);
        const float vd = s_vd[t];
        const float cc = s_c[t];
        *reinterpret_cast<float4*>(dk + gi) = make_float4(
            fmaf(u4.x * rr.x, vd, o1.x), fmaf(u4.y * rr.y, vd, o1.y),
            fmaf(u4.z * rr.z, vd, o1.z), fmaf(u4.w * rr.w, vd, o1.w));
        *reinterpret_cast<float4*>(dw + gi) =
            *reinterpret_cast<const float4*>(s_o2 + si);
        float4 a = *reinterpret_cast<const float4*>(s_part + si);
#pragma unroll
        for (int q = 1; q < C::kParts; ++q) {
          const float4 e =
              *reinterpret_cast<const float4*>(s_part + q * kChunk + si);
          a.x += e.x;
          a.y += e.y;
          a.z += e.z;
          a.w += e.w;
        }
        *reinterpret_cast<float4*>(dv + gi) =
            make_float4(fmaf(dd.x, cc, a.x), fmaf(dd.y, cc, a.y),
                        fmaf(dd.z, cc, a.z), fmaf(dd.w, cc, a.w));
        du4.x = fmaf(rr.x * kk.x, vd, du4.x);
        du4.y = fmaf(rr.y * kk.y, vd, du4.y);
        du4.z = fmaf(rr.z * kk.z, vd, du4.z);
        du4.w = fmaf(rr.w * kk.w, vd, du4.w);
      }
    }
  }
  // du of this (b, h): the threads holding columns c4 .. c4 + 3 are
  // tid = c4 / 4 + q * kVec; summed in the order of q
  __syncthreads();
  reinterpret_cast<float4*>(s_part)[tid] = du4;
  __syncthreads();
  if (tid < HS) {
    const float* parts = s_part;
    float acc = 0.0f;
    for (int q = 0; q < C::kThreads / C::kVec; ++q)
      acc += parts[(tid / 4 + q * C::kVec) * 4 + tid % 4];
    du_part[static_cast<long long>(bh) * HS + tid] = acc;
  }
}

template <int HS>
int launch_backward(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* dout,
                    float* dr, float* dk, float* dv, float* dw,
                    float* du_part, float* ckpt, float* hist, int batch,
                    int seq, int heads, cudaStream_t s) {
  using C = BwdShape<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_backward_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * heads);
  wkv6_backward_kernel<HS><<<grid, C::kThreads, C::kSmem, s>>>(
      r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt, hist, seq, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw (batch, seq, heads, hs) f32, u (heads,
// hs), du_part (batch, heads, hs), ckpt (batch * heads * ceil(seq / 16) *
// hs * hs) and hist (batch * heads * 16 * hs * hs) f32 scratch, all
// contiguous and 16-byte aligned (the wrapper checks); hs in {16, 32, 64,
// 128}. Returns cudaGetLastError() after the launch, or the error of the
// shared-memory opt-in.
extern "C" int wkv6_backward_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* dout, void* dr, void* dk, void* dv, void* dw,
    void* du_part, void* ckpt, void* hist, int batch, int seq, int heads,
    int hs, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(batch) * heads >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
#define WKV6_BWD_CASE(N)                                                    \
  case N:                                                                   \
    return launch_backward<N>(in(r), in(k), in(v), in(w), in(u), in(dout),  \
                              out(dr), out(dk), out(dv), out(dw),           \
                              out(du_part), out(ckpt), out(hist), batch,    \
                              seq, heads, s);
  switch (hs) {
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
    WKV6_BWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_BWD_CASE
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
