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
// Design: one launch, one thread block per (b, h), each thread kRows rows x
// kCols columns of the hs x hs state in registers, as in the forward. Rows
// evolve on their own and only dv sums across them, so at hs 128 the block
// walks its state in four slices of 32 rows, one after another (dv adds
// the slices in order). dw needs S_{t-1} and G_t together, and they run in
// opposite directions of time; S_{t-1} is never rebuilt from S_t by
// dividing by w_t, which reaches 0 in f32 (w = exp(-exp(.))). The states
// are recomputed instead, by two-level checkpointing, and stay on chip:
//   pass 1, forward in time: the state alone (three instructions an
//     element a step, no sums), kept at the start of every segment of kSeg
//     steps in ckpt (B*H, ceil(S/kSeg) - 1, state), the one global scratch;
//   pass 2, segments newest first: the segment's checkpoint, staged into
//     shared memory while the segment after it was walked back, walked
//     forward once, keeping the state at the start of each sub-chunk of kT
//     steps in a shared-memory slot (kSeg / kT slots); then sub-chunk by
//     sub-chunk, newest first: its kT states S_{t-1} recomputed from its
//     slot into registers (fully unrolled, static indices), and walked back
//     carrying G, emitting dr, dk, dw, dv and du's partial.
// Every walk rounds the state as the forward does (__fmul_rn / __fadd_rn),
// so each recomputed state is bit-equal to pass 1's.
// Sums over a row (dr, dk, dw: over j) cross the row's kColGroups
// neighbouring lanes: a thread's 12 values of a step are summed by a
// butterfly that halves them at each exchange (RowSum: 15 shuffles at 16
// lanes, where summing each value over the lanes takes 48), off the
// loop-carried chain, which is G's update alone. Sums over a column (dv:
// over i) cross the row groups' warps: each writes its partial to shared
// memory, and the sub-chunk's store, after one barrier, adds them in one
// fixed order (two threads an output float4 at hs 64, each adding half),
// with the bonus terms from the per-step dots v_t . dout_t and
// sum_i r_t u_t k_t. The shuffles are what this walk back spends most on
// (measured: 0.66 of 2.4 ms at the rwkv6-7b shape without them; keeping
// per-lane partials in shared memory instead cost the store more).
// Loads: k, v, w (and r, dout for a walk back) of each sub-chunk, and each
// segment's checkpoint, are copied with cp.async into a ring of kStages
// buffers, kStages - 1 sub-chunks ahead of the one computed; zeros past S.
// A thread's checkpoint copies, slot stores and slot loads touch only its
// own elements, so the slots need no barrier; the ring needs one a
// sub-chunk.
//
// What bounds it on an H100 SXM: bytes of r, k, v, w, dout read and dr, dk,
// dv, dw written once (9 * B*S*H*hs * 4: 1.21 GB, 0.36 ms at the rwkv6-7b
// shape), against f32 operations of 14 hs^2 a (b, t, h) at the fewest
// (the state once, 3; dout*S, G*v, G*k and G*S with their sums, 8; the G
// update, 3: 0.46 ms at 67 TFLOP/s). This design does 3 (pass 1) + 3 (kSeg
// - kT) / kSeg + 3 (kT - 1) / kT (the two recomputing walks) + 11 = 19.25
// hs^2 and moves 2 * 4 hs^2 bytes of checkpoints a segment beyond the
// bound's bytes (0.27 GB at that shape). As in the forward, the sequential
// walk over time sets the pace.

namespace {

template <int HS>
struct BwdShape {
  static constexpr int kSliceRows = HS == 128 ? 32 : HS;  // rows of a slice
  static constexpr int kSlices = HS / kSliceRows;
  static constexpr int kRows = 4;                           // a thread's rows
  static constexpr int kCols = HS == 16 ? 2 : 4;            // and columns
  static constexpr int kElems = kRows * kCols;
  static constexpr int kColGroups = HS / kCols;             // lanes of a row
  static constexpr int kParts = kSliceRows / kRows;         // row groups
  static constexpr int kThreads = kParts * kColGroups;
  static constexpr int kT = 8;                              // sub-chunk steps
  static constexpr int kSeg = 64;                           // segment steps
  static constexpr int kSlots = kSeg / kT;
  static constexpr int kStages = HS == 128 ? 3 : 6;         // input ring
  static constexpr int kAhead = kStages - 1;                // sub-chunks ahead
  static constexpr int kState = kSliceRows * HS;            // floats a slot
  static constexpr int kVec = HS / 4;                       // float4 a row
  static constexpr int kArr = kT * HS;                      // an array, staged
  static constexpr int kStage = 5 * kArr;                   // k, v, w, r, dout
  static constexpr int kItems = kT * kVec;                  // float4 an array
  static constexpr int kSplit = kThreads / kItems;          // threads an item
  // slots [kSlots][kState]; ring [kStages][5][kT][HS]; column partials
  // [kParts][kT][HS]; row sums [3][kT][kSliceRows] (dr, dk, dw)
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kSlots) * kState
                       + kStages * kStage + kParts * kArr
                       + 3 * kT * kSliceRows);
  static_assert(kElems % 4 == 0, "a thread's state moves as float4");
  static_assert(kColGroups <= 32 && 32 % kColGroups == 0,
                "a row's lanes within a warp");
  static_assert(kThreads % 32 == 0 && 32 % kVec == 0, "whole warps");
  static_assert(kItems * kSplit == kThreads && kSplit <= 2 &&
                    kParts % kSplit == 0,
                "one or two threads a store item");
  static_assert(kSlots > kAhead, "a slot is free when a checkpoint is staged");
  static_assert(kParts * kArr >= 4 * kThreads, "du exchange fits");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros where !valid (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// values a lane holds after RowSum<N, OFF>
template <int N, int OFF>
struct RowSumOut {
  static constexpr int value = RowSumOut<N % 2 == 0 ? N / 2 : N, OFF / 2>::value;
};
template <int N>
struct RowSumOut<N, 0> {
  static constexpr int value = N;
};

// Sums x[0 .. N) over the lanes that differ in bits OFF, OFF/2, .., 1: at
// each exchange an even count of values is halved (the lane with the bit
// set keeps the upper half and sends the lower: each sum is taken once,
// mine + theirs), an odd one is exchanged whole (both lanes add the same
// two values). On return x[0 .. RowSumOut<N, OFF>) hold the sums of the
// values first at x[start ..], start returned; every lane takes part.
template <int N, int OFF>
struct RowSum {
  __device__ static __forceinline__ int run(float* x, int lane) {
    int start = 0;
    if constexpr (N % 2 == 0) {
      const bool hi = (lane & OFF) != 0;
#pragma unroll
      for (int a = 0; a < N / 2; ++a) {
        const float mine = hi ? x[a + N / 2] : x[a];
        const float theirs = hi ? x[a] : x[a + N / 2];
        x[a] = mine + __shfl_xor_sync(0xffffffffu, theirs, OFF);
      }
      start = hi ? N / 2 : 0;
    } else {
#pragma unroll
      for (int a = 0; a < N; ++a)
        x[a] += __shfl_xor_sync(0xffffffffu, x[a], OFF);
    }
    if constexpr (OFF > 1)
      start += RowSum<N % 2 == 0 ? N / 2 : N, OFF / 2>::run(x, lane);
    return start;
  }
};

template <int HS>
__global__ void __launch_bounds__(BwdShape<HS>::kThreads, 1)
wkv6_backward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ dout, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ckpt, int seq, int heads) {
  using C = BwdShape<HS>;
  constexpr int R = C::kRows;
  constexpr int NC = C::kCols;
  constexpr int E = C::kElems;
  constexpr int T = C::kT;
  constexpr int Q = E / 4;                      // float4 of a thread's state
  constexpr int kArr = C::kArr;
  constexpr int kSlots = C::kSlots;
  // the row sums: 3 R values over kColGroups lanes; the lanes left holding
  // the same sums (kShare of them, neighbours) store them in turn
  constexpr int kSums = 3 * R;
  constexpr int kOut = RowSumOut<kSums, C::kColGroups / 2>::value;
  constexpr int kShare = C::kColGroups * kOut / kSums;
  static_assert((kShare & (kShare - 1)) == 0, "sharing lanes are neighbours");
  using V = typename VecT<NC>::type;

  extern __shared__ float4 smem4[];
  float* s_slot = reinterpret_cast<float*>(smem4);        // [kSlots][kState]
  float* s_ring = s_slot + kSlots * C::kState;           // [kStages][kStage]
  float* s_colp = s_ring + C::kStages * C::kStage;       // [kParts][T][HS]
  float* s_rows = s_colp + C::kParts * kArr;             // [3][T][kSliceRows]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j0 = (tid % C::kColGroups) * NC;  // columns j0 .. j0 + NC - 1
  const int p = tid / C::kColGroups;          // row group of the slice
  const int share = lane % kShare;

  const long long step = static_cast<long long>(heads) * HS;  // t -> t+1
  const long long base = static_cast<long long>(b) * seq * step
                         + static_cast<long long>(h) * HS;      // (b,0,h,0)

  // the walk, an item a sub-chunk: pass 1 (k, v, w of sub-chunks 0 ..
  // n_pass1 - 1), then per segment, newest first, its forward items
  // (sub-chunks 0 .. nsub - 2) and its walk-back items (nsub - 1 .. 0); the
  // same again for each slice
  const int nseg = (seq + C::kSeg - 1) / C::kSeg;
  const int last = nseg - 1;
  const int nsub_last = (seq - last * C::kSeg + T - 1) / T;
  const int n_pass1 = last * kSlots;
  // the slot a segment's sub-chunk 0 uses: the last segment's is 0; the
  // checkpoint of the one before it is staged kAhead items ahead, into a
  // slot whose walk-back item came earlier (or one the last never uses)
  const int base_2nd = nsub_last > C::kAhead ? nsub_last - 1 : nsub_last;
  auto slot_base = [&](int s) {
    return s == last ? 0
                     : (base_2nd + (kSlots - 1) * (last - 1 - s)) % kSlots;
  };
  // this thread's float4 q of a kept state sits at [q * kThreads + tid],
  // in the slots and in ckpt alike: every copy is coalesced
  float4* my_ckpt = reinterpret_cast<float4*>(ckpt)
                    + static_cast<long long>(bh) * last * (C::kState / 4) + tid;
  auto slot4 = [&](int slot) {
    return reinterpret_cast<float4*>(s_slot + slot * C::kState) + tid;
  };

  // the next item to stage: pass 1's sub-chunk nx_c while nx_c < n_pass1,
  // then item nx_loc of segment nx_s (its forward items, then its walk
  // back), of slice nx_slice
  int nx_slice = 0, nx_c = 0, nx_s = last, nx_loc = 0;
  auto advance = [&]() {
    if (nx_c < n_pass1) {
      ++nx_c;
      return;
    }
    const int nsub = nx_s == last ? nsub_last : kSlots;
    if (++nx_loc < 2 * nsub - 1) return;
    nx_loc = 0;
    if (nx_s > 0) {
      --nx_s;
      return;
    }
    ++nx_slice;
    nx_c = 0;
    nx_s = last;
  };
  // stage the next item into ring buffer it % kStages (every thread copies
  // its 16-byte pieces of the item's arrays; zeros past S), then advance
  constexpr int kCopies = (5 * C::kItems + C::kThreads - 1) / C::kThreads;
  auto issue = [&](int it) {
    if (nx_slice < C::kSlices) {
      int t0, narr = 3, ck_seg = -1;
      if (nx_c < n_pass1) {
        t0 = nx_c * T;
      } else {
        const int nsub = nx_s == last ? nsub_last : kSlots;
        const bool fwd = nx_loc < nsub - 1;
        t0 = nx_s * C::kSeg + (fwd ? nx_loc : 2 * nsub - 2 - nx_loc) * T;
        narr = fwd ? 3 : 5;
        if (nx_loc == 0 && nx_s != last) ck_seg = nx_s;
      }
      float* stg = s_ring + (it % C::kStages) * C::kStage;
#pragma unroll
      for (int n = 0; n < kCopies; ++n) {
        const int pc = tid + n * C::kThreads;
        if (pc < narr * C::kItems) {
          const int a = pc / C::kItems;
          const int rem = pc % C::kItems;
          const int t = rem / C::kVec;
          const float* src = a == 0 ? k : a == 1 ? v : a == 2 ? w
                           : a == 3 ? r : dout;
          const bool ok = t0 + t < seq;
          cp_async16(smem_addr(stg + a * kArr + rem * 4),
                     ok ? src + base + (t0 + t) * step + (rem % C::kVec) * 4
                        : src,
                     ok);
        }
      }
      if (ck_seg >= 0) {
        // written by this thread in pass 1, long before
        const float4* src = my_ckpt + static_cast<long long>(ck_seg)
                                          * (C::kState / 4);
        float4* dst = slot4(slot_base(ck_seg));
#pragma unroll
        for (int q = 0; q < Q; ++q)
          cp_async16(smem_addr(dst + q * C::kThreads), src + q * C::kThreads,
                     true);
      }
      advance();
    }
    cp_async_commit();
  };
  int item = 0;
  // the next item's stage, once every thread's copies have landed and the
  // item before it is consumed; the one kAhead later is put in flight
  auto begin = [&]() -> const float* {
    cp_async_wait<C::kAhead - 1>();
    __syncthreads();
    issue(item + C::kAhead);
    return s_ring + (item++ % C::kStages) * C::kStage;
  };

  auto store_state = [&](float4* dst, const float (&x)[E]) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      dst[q * C::kThreads] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  };
  auto load_state = [&](const float4* src, float (&x)[E]) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 a = src[q * C::kThreads];
      x[4 * q] = a.x;
      x[4 * q + 1] = a.y;
      x[4 * q + 2] = a.z;
      x[4 * q + 3] = a.w;
    }
  };

  float4 du4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c4 = (tid % C::kVec) * 4;  // a store item's columns / rows
  const float* uh = u + h * HS + c4;
  const float4 u4 = make_float4(uh[0], uh[1], uh[2], uh[3]);

  for (int a = 0; a < C::kAhead; ++a) issue(a);

  for (int slice = 0; slice < C::kSlices; ++slice) {
    const int i0 = slice * C::kSliceRows + p * R;  // rows i0 .. i0 + R - 1

    // one step forward of x, as the forward rounds it
    auto walk = [&](const float* stg, float (&x)[E]) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const V vr = *reinterpret_cast<const V*>(stg + kArr + t * HS + j0);
        const float* vv = reinterpret_cast<const float*>(&vr);
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const float kk = lds(stg + t * HS + i0 + m);
          const float ww = lds(stg + 2 * kArr + t * HS + i0 + m);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            x[m * NC + c] = __fadd_rn(__fmul_rn(ww, x[m * NC + c]),
                                      __fmul_rn(kk, vv[c]));
        }
      }
    };

    // ---- pass 1: forward in time, the state alone ------------------------
    {
      float st[E];
#pragma unroll
      for (int e = 0; e < E; ++e) st[e] = 0.0f;
      for (int c = 0; c < n_pass1; ++c) {
        const float* stg = begin();
        if (c % kSlots == 0)
          store_state(my_ckpt + static_cast<long long>(c / kSlots)
                                      * (C::kState / 4), st);
        walk(stg, st);
      }
      store_state(slot4(0), st);  // the last segment's start
    }

    // ---- pass 2: segments newest first, carrying G -----------------------
    float g[E];
#pragma unroll
    for (int e = 0; e < E; ++e) g[e] = 0.0f;
    for (int s = last; s >= 0; --s) {
      const int nsub = s == last ? nsub_last : kSlots;
      const int sb = slot_base(s);
      if (nsub > 1) {
        // the segment walked forward once, its sub-chunks' starts kept
        float st[E];
        const float* stg = begin();
        load_state(slot4(sb), st);
        walk(stg, st);
        store_state(slot4((sb + 1) % kSlots), st);
        for (int j = 1; j < nsub - 1; ++j) {
          stg = begin();
          walk(stg, st);
          store_state(slot4((sb + j + 1) % kSlots), st);
        }
      }
      for (int j = nsub - 1; j >= 0; --j) {
        const float* stg = begin();
        const int t0 = s * C::kSeg + j * T;
        // S_{t0-1} .. S_{t0+T-2}, recomputed from the sub-chunk's slot
        float prev[T][E];
        load_state(slot4((sb + j) % kSlots), prev[0]);
#pragma unroll
        for (int t = 0; t + 1 < T; ++t) {
          const V vr = *reinterpret_cast<const V*>(stg + kArr + t * HS + j0);
          const float* vv = reinterpret_cast<const float*>(&vr);
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const float kk = lds(stg + t * HS + i0 + m);
            const float ww = lds(stg + 2 * kArr + t * HS + i0 + m);
#pragma unroll
            for (int c = 0; c < NC; ++c)
              prev[t + 1][m * NC + c] =
                  __fadd_rn(__fmul_rn(ww, prev[t][m * NC + c]),
                            __fmul_rn(kk, vv[c]));
          }
        }
        // the walk back (steps past S were staged as zeros: G stays 0)
#pragma unroll
        for (int t = T - 1; t >= 0; --t) {
          const V vr = *reinterpret_cast<const V*>(stg + kArr + t * HS + j0);
          const V dr4 =
              *reinterpret_cast<const V*>(stg + 4 * kArr + t * HS + j0);
          const float* vv = reinterpret_cast<const float*>(&vr);
          const float* dd = reinterpret_cast<const float*>(&dr4);
          float x[kSums];
          V dvp_raw;
          float* dvp = reinterpret_cast<float*>(&dvp_raw);
#pragma unroll
          for (int c = 0; c < NC; ++c) dvp[c] = 0.0f;
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const float kk = lds(stg + t * HS + i0 + m);
            const float ww = lds(stg + 2 * kArr + t * HS + i0 + m);
            const float rr = lds(stg + 3 * kArr + t * HS + i0 + m);
            float a_r = 0.0f, a_k = 0.0f, a_w = 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const float sp = prev[t][m * NC + c];
              const float gg = g[m * NC + c];
              a_r = fmaf(dd[c], sp, a_r);
              a_k = fmaf(gg, vv[c], a_k);
              a_w = fmaf(gg, sp, a_w);
              dvp[c] = fmaf(gg, kk, dvp[c]);
              g[m * NC + c] = fmaf(rr, dd[c], ww * gg);
            }
            x[m] = a_r;
            x[R + m] = a_k;
            x[2 * R + m] = a_w;
          }
          *reinterpret_cast<V*>(s_colp + (p * T + t) * HS + j0) = dvp_raw;
          const int start =
              RowSum<kSums, C::kColGroups / 2>::run(x, lane);
#pragma unroll
          for (int a = 0; a < kOut; ++a) {
            if (a % kShare == share) {
              const int idx = start + a;  // (sum idx / R) of row idx % R
              s_rows[((idx / R) * T + t) * C::kSliceRows + p * R + idx % R] =
                  x[a];
            }
          }
        }
        __syncthreads();
        // the sub-chunk's gradients: a float4 of a step an item, kSplit
        // threads an item (neighbouring groups of kVec lanes), each adding
        // its share of the row groups' column partials
        {
          const int t = tid / (C::kVec * C::kSplit);
          const int half = (tid / C::kVec) % C::kSplit;
          const int si = t * HS + c4;
          const float4 kk = *reinterpret_cast<const float4*>(stg + si);
          const float4 vv = *reinterpret_cast<const float4*>(stg + kArr + si);
          const float4 rr =
              *reinterpret_cast<const float4*>(stg + 3 * kArr + si);
          const float4 dd =
              *reinterpret_cast<const float4*>(stg + 4 * kArr + si);
          float cc = rr.x * u4.x * kk.x;
          cc = fmaf(rr.y * u4.y, kk.y, cc);
          cc = fmaf(rr.z * u4.z, kk.z, cc);
          cc = fmaf(rr.w * u4.w, kk.w, cc);
          float vd = vv.x * dd.x;
          vd = fmaf(vv.y, dd.y, vd);
          vd = fmaf(vv.z, dd.z, vd);
          vd = fmaf(vv.w, dd.w, vd);
#pragma unroll
          for (int off = 1; off < C::kVec; off <<= 1) {
            cc += __shfl_xor_sync(0xffffffffu, cc, off);
            vd += __shfl_xor_sync(0xffffffffu, vd, off);
          }
          constexpr int kShareParts = C::kParts / C::kSplit;
          const float* part = s_colp + half * kShareParts * kArr + si;
          float4 a = *reinterpret_cast<const float4*>(part);
#pragma unroll
          for (int q = 1; q < kShareParts; ++q) {
            const float4 e = *reinterpret_cast<const float4*>(part + q * kArr);
            a.x += e.x;
            a.y += e.y;
            a.z += e.z;
            a.w += e.w;
          }
          if constexpr (C::kSplit == 2) {  // mine + theirs: the same bits
            a.x += __shfl_xor_sync(0xffffffffu, a.x, C::kVec);
            a.y += __shfl_xor_sync(0xffffffffu, a.y, C::kVec);
            a.z += __shfl_xor_sync(0xffffffffu, a.z, C::kVec);
            a.w += __shfl_xor_sync(0xffffffffu, a.w, C::kVec);
          }
          const int lr = c4 - slice * C::kSliceRows;  // row in the slice
          const bool rows_here = lr >= 0 && lr < C::kSliceRows;
          if (t0 + t < seq) {
            const long long gi = base + (t0 + t) * step + c4;
            if (half == 0) {  // dv, dr
              float4* dv4 = reinterpret_cast<float4*>(dv + gi);
              if (slice == 0) {
                *dv4 = make_float4(fmaf(dd.x, cc, a.x), fmaf(dd.y, cc, a.y),
                                   fmaf(dd.z, cc, a.z), fmaf(dd.w, cc, a.w));
              } else {  // the earlier slices' rows, stored by this thread
                const float4 o = *dv4;
                *dv4 = make_float4(o.x + a.x, o.y + a.y, o.z + a.z,
                                   o.w + a.w);
              }
              if (rows_here) {
                const float4 o_r = *reinterpret_cast<const float4*>(
                    s_rows + t * C::kSliceRows + lr);
                *reinterpret_cast<float4*>(dr + gi) = make_float4(
                    fmaf(u4.x * kk.x, vd, o_r.x),
                    fmaf(u4.y * kk.y, vd, o_r.y),
                    fmaf(u4.z * kk.z, vd, o_r.z),
                    fmaf(u4.w * kk.w, vd, o_r.w));
              }
            }
            if (half == C::kSplit - 1 && rows_here) {  // dk, dw, du
              const float4 o_k = *reinterpret_cast<const float4*>(
                  s_rows + (T + t) * C::kSliceRows + lr);
              const float4 o_w = *reinterpret_cast<const float4*>(
                  s_rows + (2 * T + t) * C::kSliceRows + lr);
              *reinterpret_cast<float4*>(dk + gi) = make_float4(
                  fmaf(u4.x * rr.x, vd, o_k.x), fmaf(u4.y * rr.y, vd, o_k.y),
                  fmaf(u4.z * rr.z, vd, o_k.z), fmaf(u4.w * rr.w, vd, o_k.w));
              *reinterpret_cast<float4*>(dw + gi) = o_w;
              du4.x = fmaf(rr.x * kk.x, vd, du4.x);
              du4.y = fmaf(rr.y * kk.y, vd, du4.y);
              du4.z = fmaf(rr.z * kk.z, vd, du4.z);
              du4.w = fmaf(rr.w * kk.w, vd, du4.w);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  // du of this (b, h): the threads holding columns c4 .. c4 + 3 are
  // tid = c4 / 4 + q * kVec; summed in the order of q
  __syncthreads();
  reinterpret_cast<float4*>(s_colp)[tid] = du4;
  __syncthreads();
  if (tid < HS) {
    const float* parts = s_colp;
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
                    float* du_part, float* ckpt, int batch, int seq,
                    int heads, cudaStream_t s) {
  using C = BwdShape<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_backward_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * heads);
  wkv6_backward_kernel<HS><<<grid, C::kThreads, C::kSmem, s>>>(
      r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt, seq, heads);
  return static_cast<int>(cudaGetLastError());
}

template <int HS>
void backward_geometry(long long* out) {
  using C = BwdShape<HS>;
  const long long g[] = {C::kThreads, C::kRows, C::kCols, C::kT, C::kSeg,
                         C::kSlices, C::kStages,
                         static_cast<long long>(C::kSmem)};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw (batch, seq, heads, hs) f32, u (heads,
// hs), du_part (batch, heads, hs) and the checkpoint scratch ckpt (batch *
// heads * (ceil(seq / 64) - 1) * hs * hs floats; may be empty) f32, all
// contiguous and 16-byte aligned (the wrapper checks); hs in {16, 32, 64,
// 128}. Returns cudaGetLastError() after the launch, or the error of the
// shared-memory opt-in.
extern "C" int wkv6_backward_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* dout, void* dr, void* dk, void* dv, void* dw,
    void* du_part, void* ckpt, int batch, int seq, int heads, int hs,
    void* stream) {
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
                              out(du_part), out(ckpt), batch, seq, heads,   \
                              s);
  switch (hs) {
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
    WKV6_BWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_BWD_CASE
}

// The backward's geometry for head size hs into out[8]: threads, rows and
// columns a thread, sub-chunk and segment steps, slices, ring stages and
// shared-memory bytes (rwkv6_scan.backward_geometry mirrors it). Returns 0,
// or cudaErrorInvalidValue for another hs.
extern "C" int wkv6_backward_geometry(int hs, long long* out) {
  switch (hs) {
    case 16: backward_geometry<16>(out); return 0;
    case 32: backward_geometry<32>(out); return 0;
    case 64: backward_geometry<64>(out); return 0;
    case 128: backward_geometry<128>(out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
