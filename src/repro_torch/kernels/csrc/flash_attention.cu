// Blockwise (flash) attention kernel for Hopper (sm_90a), bound through a
// plain C interface (loaded with ctypes by
// repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py:123 (_flash_kernel, :31): the
// full-sequence attention of layers.attn_apply(use_kernel=True), run by
// transformer.forward / loss_fn for prefill and loss evaluation.
//
// What it computes, for q (B, S, H, hd) and k, v (B, S, KV, hd) in the
// reference's public layout (no transposed copies), bf16 or f32:
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / KV)]
//   s_ij = (q_i . k_j) * (1 / sqrt(hd)), visible(i, j), else -1e30
//   visible(i, j) = (!causal || j <= i || j < prefix_len)
//                   && (!window || j > i - window)
// which is the reference model's mask (layers._mask_bias): the window
// does NOT exempt prefix keys. Every product, sum and the online-softmax
// state (m, l, acc) are f32 on CUDA cores, P stays f32 for P.V (as in
// _flash_kernel, which upcasts v), and the output is acc / max(l, 1e-20)
// rounded to q's dtype. The masked sentinel is the finite -1e30, never
// -inf: a row masked so far gets p = 1 and is wiped by
// alpha = exp(-1e30 - m) = 0 once a visible key arrives.
//
// Block skip: a kv tile is visited iff some pair in it is visible:
//   causal: k_lo <= q_hi || (prefix_len > 0 && k_lo < prefix_len)
//   window: k_hi > q_lo - window
// The Pallas kernel's skip lacks the prefix term under causal and so
// drops prefix keys beyond the first q block; this one does not.
//
// Bound on an H100 SXM: visible pairs * 4 * hd FLOP against 67 TFLOP/s
// in f32 on CUDA cores (this kernel) or 989 TFLOP/s bf16 on tensor cores
// (a later wgmma redesign); bytes of q, k, v and o once against
// 3.35 TB/s. At the smollm-135m prefill shape (B, S, H, KV, hd) =
// (4, 2048, 9, 3, 64), causal: 1.93e10 FLOP, 0.29 ms in f32, 0.020 ms in
// bf16, 25 MB = 0.0075 ms of bytes: compute-bound either way.
//
// Design (simple and right first): one thread block of 256 threads per
// (64-row q tile, head, batch). The q tile sits in shared memory as f32;
// the block walks the 64-row kv tiles in order, staging K and V as f32 in
// shared memory (217 KB at hd = 256, under the 227 KB opt-in). Threads
// form a 16 x 16 grid: thread (ty, tx) owns q rows ty + 16 r (r < 4),
// score columns tx + 16 c (c < 4) and output columns 4 tx + 64 m + e, so
// the running max and sum of a row live in the registers of the 16
// threads of one half warp and are reduced with shuffles, and the f32
// accumulator (4 x hd/16 per thread) never leaves registers. P goes
// through shared memory for P.V. Shared memory is read 16 bytes at a time
// (four consecutive d of q and k, four consecutive j of P, four
// consecutive output columns of v) and rows are padded by four floats,
// so a warp's reads take the fewest wavefronts and the FMA pipe, not
// shared memory, sets the pace; the sums still run over d and j in
// order. Global loads and stores move 16 bytes per thread along hd.
// Rows past S (a ragged last tile) are loaded as zeros, masked and not
// stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                 // q rows per thread block
constexpr int kBK = 64;                 // kv rows per tile
constexpr int kRows = kBQ / 16;         // q rows per thread
constexpr int kCols = kBK / 16;         // score columns per thread
constexpr int kPad = 4;                 // floats of padding per smem row
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((static_cast<size_t>(kBQ) + 2 * kBK) * (HD + kPad)
                          + kBQ * (kBK + kPad));
}

// half-warp butterflies: the 16 lanes of one row group end equal
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// 16 bytes of global memory as f32 into smem (8 bf16 or 4 f32 values)
__device__ __forceinline__ void to_smem(float* dst, uint4 raw,
                                        const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ void to_smem(float* dst, uint4 raw, const float*) {
  *reinterpret_cast<uint4*>(dst) = raw;
}

// four f32 values to global memory in T
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  // round to nearest even, as torch's cast
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// rows [row0, row0 + n) of one head of a (B, S, heads, HD) tensor into
// f32 shared memory with row stride HD + kPad; rows at or past S become
// zeros. Consecutive threads read consecutive 16-byte chunks of a row.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          size_t row_stride, int row0, int n,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int d = (e % kChunks) * kVec;
    const int s = row0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (s < S) {
      raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(s) * row_stride + d);
    }
    to_smem(dst + r * (HD + kPad) + d, raw, src);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int KV, float scale, int causal, int window, int prefix_len) {
  constexpr int LD = HD + kPad;          // row stride of q, k, v in smem
  constexpr int LP = kBK + kPad;         // row stride of P in smem
  constexpr int kM = HD / 64;            // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* ks = qs + kBQ * LD;                     // [kBK][LD]
  float* vs = ks + kBK * LD;                     // [kBK][LD]
  float* ps = vs + kBK * LD;                     // [kBQ][LP]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q_lo = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const T* qb = q + static_cast<size_t>(b) * S * q_row
                + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row
                + static_cast<size_t>(kvh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row
                + static_cast<size_t>(kvh) * HD;
  T* ob = o + static_cast<size_t>(b) * S * q_row
          + static_cast<size_t>(h) * HD;

  load_tile<HD>(qs, qb, q_row, q_lo, kBQ, S);

  float m[kRows], l[kRows];
  float4 acc[kRows][kM];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kM; ++i) acc[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int q_hi = min(q_lo + kBQ, S) - 1;
  for (int k_lo = 0; k_lo < S; k_lo += kBK) {
    const int k_hi = min(k_lo + kBK, S) - 1;
    if (causal && !(k_lo <= q_hi || (prefix_len > 0 && k_lo < prefix_len)))
      continue;                                  // uniform over the block
    if (window > 0 && !(k_hi > q_lo - window)) continue;

    __syncthreads();       // the previous tile's P.V is done with ks/vs/ps
    load_tile<HD>(ks, kb, kv_row, k_lo, kBK, S);
    load_tile<HD>(vs, vb, kv_row, k_lo, kBK, S);
    __syncthreads();

    // S = Q K^T for this thread's rows x columns, f32 FMAs over d in order
    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv4[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = lds4(qs + (ty + 16 * r) * LD + d);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kv4[c] = lds4(ks + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float a = s[r][c];
          a = fmaf(qv[r].x, kv4[c].x, a);
          a = fmaf(qv[r].y, kv4[c].y, a);
          a = fmaf(qv[r].z, kv4[c].z, a);
          s[r][c] = fmaf(qv[r].w, kv4[c].w, a);
        }
    }

    // mask, online softmax; P to shared memory
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q_lo + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kj = k_lo + tx + 16 * c;
        bool vis = kj < S;
        if (causal)
          vis = vis && (kj <= qi || (prefix_len > 0 && kj < prefix_len));
        if (window > 0) vis = vis && (kj > qi - window);
        s[r][c] = vis ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_cur = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - m_cur);
        sum += p;
        ps[(ty + 16 * r) * LP + tx + 16 * c] = p;
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_cur;
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        acc[r][i].x *= alpha;
        acc[r][i].y *= alpha;
        acc[r][i].z *= alpha;
        acc[r][i].w *= alpha;
      }
    }
    __syncthreads();

    // acc += P V over j in order, P kept in f32
#pragma unroll 1
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = lds4(ps + (ty + 16 * r) * LP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const float4 vv = lds4(vs + (j + jj) * LD + 64 * i + 4 * tx);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y
                          : jj == 2 ? pv[r].z : pv[r].w;
            acc[r][i].x = fmaf(p, vv.x, acc[r][i].x);
            acc[r][i].y = fmaf(p, vv.y, acc[r][i].y);
            acc[r][i].z = fmaf(p, vv.z, acc[r][i].z);
            acc[r][i].w = fmaf(p, vv.w, acc[r][i].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q_lo + ty + 16 * r;
    if (qi >= S) continue;
    const float inv = fmaxf(l[r], 1e-20f);
    T* dst = ob + static_cast<size_t>(qi) * q_row;
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const float4 a = acc[r][i];
      store4(dst + 64 * i + 4 * tx,
             make_float4(a.x / inv, a.y / inv, a.z / inv, a.w / inv));
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, float scale, int causal, int window,
           int prefix_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, scale, causal,
      window, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int hd, float scale, int causal,
             int window, int prefix_len, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64, T>(q, k, v, o, B, S, H, KV, scale, causal, window,
                           prefix_len, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, S, H, KV, scale, causal, window,
                            prefix_len, stream);
    case 256:
      return launch<256, T>(q, k, v, o, B, S, H, KV, scale, causal, window,
                            prefix_len, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o (B, S, H, hd); k, v (B, S, KV, hd); all contiguous, of one dtype
// (is_bf16 != 0: bf16, else f32); hd in {64, 128, 256}; H % KV == 0; B, S,
// H and KV positive (the wrapper never passes an empty tensor).
// window <= 0 means no window. Returns cudaGetLastError() after the
// launch, or the error of the shared-memory opt-in.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int hd, int is_bf16,
                                      float scale, int causal, int window,
                                      int prefix_len, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, scale,
                                   causal, window, prefix_len, s);
  }
  return dispatch<float>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                         prefix_len, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
