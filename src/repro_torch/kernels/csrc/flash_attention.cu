// Blockwise (flash) attention kernels for Hopper (sm_90a), bound through a
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
// does NOT exempt prefix keys. The online-softmax state (m, l, acc) is
// f32 and the output is acc / max(l, 1e-20) rounded to q's dtype (to
// nearest even). The masked sentinel is the finite -1e30, never -inf: a
// row masked so far gets p = 1 and is wiped by alpha = exp(-1e30 - m) = 0
// once a visible key arrives.
//
// Tile visits: only the kv tiles holding a visible pair, which for every
// mask is one contiguous range of tiles:
//   causal: k_lo <= q_hi || (prefix_len > 0 && k_lo < prefix_len)
//   window: k_hi > q_lo - window
// The Pallas kernel's skip lacks the prefix term under causal and so
// drops prefix keys beyond the first q block; this one does not.
//
// What bounds it on an H100 SXM: visible pairs * 4 * hd FLOP against 989
// TFLOP/s bf16 on tensor cores; bytes of q, k, v and o once against
// 3.35 TB/s. At the smollm-135m prefill shape (B, S, H, KV, hd) =
// (4, 2048, 9, 3, 64), causal: 1.93e10 FLOP, 0.020 ms on tensor cores
// (0.29 ms in f32 on CUDA cores), 25 MB = 0.0075 ms of bytes:
// compute-bound.
//
// Two bodies, chosen by the input dtype:
//
// * bf16 inputs (the model's path): flash_kernel_tc, both products on
//   tensor cores with f32 accumulation, the FlashAttention-2 structure
//   with mma.sync.m16n8k16. One 128-thread block (four warps, 16 q rows
//   each) per (64-row q tile, head, batch); 64-row tiles give every path
//   shape enough blocks (paligemma's B=2, S=512, H=8: 128). The grid's
//   slowest dimension is the q tile, walked from the last, so the
//   longest causal tiles launch first. Q (64 x hd) and a two-stage ring
//   of K and V tiles (64 x hd each; 32 x hd at hd 256) live in shared
//   memory as bf16, rows XOR-swizzled by 16-byte chunk so that ldmatrix
//   reads are free of bank conflicts (the row stride is hd rounded up to
//   64 elements: at hd 80 and 112 the XOR would otherwise carry a chunk
//   into the next row); the next tile's cp.async loads are
//   in flight while this tile's products run. Registers bound the design
//   at hd 256, where a warp's 16 x 256 f32 accumulator takes 128 a
//   thread: there Q fragments are read again from shared memory per tile
//   (kept in registers for hd <= 128) and the kv tile is 32 rows, so the
//   score tile takes 16. QK^T: Q and K fragments from ldmatrix; bf16 x
//   bf16 products are exact in f32, so only the order of the sum differs
//   from the plain version.
//   The per-element mask runs only on tiles that straddle a mask edge.
//   The softmax runs in the log2 domain (ex2.approx). P is rounded to bf16 in
//   registers and fed straight back as the A operand of P.V (the C and A
//   fragment layouts of m16n8k16 line up), V fragments from
//   ldmatrix.trans: the precision of the reference model's own plain
//   attention, which casts probs.to(v.dtype) before its einsum. The
//   output is staged through Q's shared memory and written 16 bytes a
//   thread. Design choice: wgmma (64-row warpgroup tiles, B from shared
//   memory through descriptors) is the route to the card's full rate;
//   mma.sync reaches a fraction of it but needs no descriptor or
//   swizzle-mode encoding that can only be debugged on the card.
//
// * f32 inputs: flash_kernel_f32, every product on CUDA cores in f32, P
//   kept in f32 (as _flash_kernel upcasts v). The reference's f32
//   tolerance (2e-5) is beyond bf16 and TF32 tensor cores, so this body
//   stays. One 256-thread block per (64-row q tile, head, batch); q, K,
//   V and P staged as f32 in shared memory (up to 217 KB at hd 256), a
//   16 x 16 thread grid with each row's max and sum in one half warp,
//   16-byte shared-memory reads and rows padded by four floats. Each tx
//   thread owns float4 output columns 4 tx + 64 i; at hd 80 and 112 the
//   last pass over the columns is partial.
//
// Rows past S (a ragged last tile) are loaded as zeros, masked and not
// stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;         // four warps
constexpr int kTcBQ = 64;               // q rows per block, 16 per warp
constexpr int kTcStages = 2;            // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// kv rows per tile: 32 at hd 256, where a warp's 16 x 256 f32 accumulator
// already takes 128 registers a thread and a 64-wide score tile spills
template <int HD>
constexpr int kTcBK = HD == 256 ? 32 : 64;

// row stride of the shared tiles in bf16 elements: HD rounded up to a
// multiple of 64 (eight 16-byte chunks), so that the XOR of swz stays
// inside its row at every HD (80 has 10 chunks a row, 112 has 14) and a
// row starts in bank 0
template <int HD>
constexpr int kTcLd = (HD + 63) / 64 * 64;

template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * kTcLd<HD>
         * (static_cast<size_t>(kTcBQ) + 2 * kTcStages * kTcBK<HD>);
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile:
// the chunk index is XORed with row % 8, so the eight rows one ldmatrix
// phase reads sit in eight distinct bank groups; with the row stride a
// multiple of eight chunks the XOR never leaves the row
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kTcLd<HD> + ((chunk ^ (row & 7)) << 3);
}

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

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
               "{%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// two f32 as bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of one head of a (B, S, heads, HD) bf16 tensor
// into a swizzled shared tile, asynchronously; rows at or past S are zeros
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, size_t row_stride,
    int row0, int S) {
  constexpr int kChunks = HD / 8;
  static_assert(ROWS * kChunks % kTcThreads == 0, "whole loads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / kChunks;
    const int c = e % kChunks;
    const int s = row0 + r;
    const bool valid = s < S;
    cp_async16(dst + 2 * swz<HD>(r, c),
               src + static_cast<size_t>(valid ? s : 0) * row_stride + 8 * c,
               valid);
  }
}

// 2^x as the special-function unit's one instruction (about 2 ulp;
// -1e30 gives 0, 0 gives 1): exp2f wraps it in range handling that cost
// 10 % of the kernel's time at the smollm shape on an H100
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                float scale_log2, int causal, int window, int prefix_len) {
  constexpr int kK = HD / 16;            // k-steps of QK^T
  constexpr int kN = HD / 8;             // 8-column tiles of the output
  constexpr bool kQinRegs = HD <= 128;
  constexpr int BK = kTcBK<HD>;
  constexpr int kTile = BK * kTcLd<HD>;  // elements of one K or V tile
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTcBQ * kTcLd<HD>;       // [stage][BK][ld]
  __nv_bfloat16* vs = ks + kTcStages * kTile;          // [stage][BK][ld]
  const uint32_t qs_a = smem_addr(qs);
  const uint32_t ks_a = smem_addr(ks);
  const uint32_t vs_a = smem_addr(vs);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                // fragment row (and row + 8)
  const int tq = lane % 4;               // fragment column pair
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_lo = (gridDim.z - 1 - blockIdx.z) * kTcBQ;   // longest first
  const int q_hi = min(q_lo + kTcBQ, S) - 1;
  const int kvh = h / (H / KV);
  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * S * q_row
                            + static_cast<size_t>(h) * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * kv_row
                            + static_cast<size_t>(kvh) * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * kv_row
                            + static_cast<size_t>(kvh) * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * S * q_row
                      + static_cast<size_t>(h) * HD;

  // the visited kv tiles [t_begin, t_end): one range for every mask
  int t_end = (S + BK - 1) / BK;
  if (causal) t_end = min(t_end, max(q_hi, prefix_len - 1) / BK + 1);
  const int t_begin = window > 0 ? max(0, (q_lo - window + 1) / BK) : 0;

  load_tile_async<HD, kTcBQ>(qs_a, qb, q_row, q_lo, S);
  load_tile_async<HD, BK>(ks_a, kb, kv_row, t_begin * BK, S);
  load_tile_async<HD, BK>(vs_a, vb, kv_row, t_begin * BK, S);
  cp_async_commit();

  // ldmatrix lane addressing (row within a 16-row block, chunk offset)
  const int a_row = warp * 16 + (lane % 16);        // Q: A operand
  const int a_chk = lane / 16;
  const int b_row = (lane % 8) + (lane / 16) * 8;   // K: B operand
  const int b_chk = (lane / 8) % 2;
  const int v_row = (lane % 8) + ((lane / 8) % 2) * 8;  // V: B, transposed
  const int v_chk = lane / 16;

  uint32_t qf[kQinRegs ? kK : 1][4];
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;      // rows g and g + 8, log2 domain
  float l0 = 0.0f, l1 = 0.0f;            // this thread's part of the sums
  const int qi0 = q_lo + warp * 16 + g;  // query of row g (row g+8: +8)

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % kTcStages;
    if (t + 1 < t_end) {
      const int nxt = (stage + 1) % kTcStages;
      load_tile_async<HD, BK>(ks_a + 2 * nxt * kTile, kb, kv_row,
                              (t + 1) * BK, S);
      load_tile_async<HD, BK>(vs_a + 2 * nxt * kTile, vb, kv_row,
                              (t + 1) * BK, S);
    }
    cp_async_commit();
    cp_async_wait_1();                   // tile t (and Q) have landed
    __syncthreads();
    if constexpr (kQinRegs) {
      if (t == t_begin) {
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          ldsm_x4(qf[kk], qs_a + 2 * swz<HD>(a_row, 2 * kk + a_chk));
      }
    }
    const uint32_t kt_a = ks_a + 2 * stage * kTile;
    const uint32_t vt_a = vs_a + 2 * stage * kTile;

    // S = Q K^T: 16 q rows x BK kv columns per warp, f32
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t a[4];
      if constexpr (kQinRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, qs_a + 2 * swz<HD>(a_row, 2 * kk + a_chk));
      }
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4(bf, kt_a + 2 * swz<HD>(16 * nn + b_row, 2 * kk + b_chk));
        mma_bf16(s[2 * nn], a, bf[0], bf[1]);
        mma_bf16(s[2 * nn + 1], a, bf[2], bf[3]);
      }
    }

    // scale to the log2 domain; mask only a tile that straddles an edge
    const int k_lo = t * BK;
    const int k_last = k_lo + BK - 1;
    const bool edge =
        k_last >= S
        || (causal && !(k_last <= q_lo || k_last < prefix_len))
        || (window > 0 && !(k_lo > q_lo + kTcBQ - 1 - window));
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int qi = qi0 + (e >= 2 ? 8 : 0);
          const int kj = k_lo + 8 * n + 2 * tq + (e & 1);
          bool vis = kj < S;
          if (causal) vis = vis && (kj <= qi || kj < prefix_len);
          if (window > 0) vis = vis && (kj > qi - window);
          x = vis ? x : kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax: each row lives in the four lanes of one quad
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = ex2(s[n][0] - mn0);
      s[n][1] = ex2(s[n][1] - mn0);
      s[n][2] = ex2(s[n][2] - mn1);
      s[n][3] = ex2(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += P V: P in bf16 as the A operand, 16 kv rows per k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < kN / 2; ++nn) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vt_a + 2 * swz<HD>(16 * kk + v_row, 2 * nn + v_chk));
        mma_bf16(acc[2 * nn], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nn + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                     // done with this stage's K and V
  }

  // o = acc / max(l, 1e-20) in bf16, through this warp's rows of Q's
  // shared tile, then 16 bytes a thread to global memory
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  const int r0 = warp * 16 + g;
  uint32_t* qs32 = reinterpret_cast<uint32_t*>(qs);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    qs32[(swz<HD>(r0, n) + 2 * tq) / 2] =
        pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    qs32[(swz<HD>(r0 + 8, n) + 2 * tq) / 2] =
        pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * kN / 32; ++i) {
    const int e = lane + 32 * i;
    const int row = warp * 16 + e / kN;
    const int c = e % kN;
    const int qi = q_lo + row;
    if (qi < S) {
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(qi) * q_row
                                + 8 * c) =
          *reinterpret_cast<const uint4*>(qs + swz<HD>(row, c));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;                 // q rows per thread block
constexpr int kBK = 64;                 // kv rows per tile
constexpr int kRows = kBQ / 16;         // q rows per thread
constexpr int kCols = kBK / 16;         // score columns per thread
constexpr int kPad = 4;                 // floats of padding per smem row

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

// rows [row0, row0 + n) of one head of a (B, S, heads, HD) f32 tensor into
// shared memory with row stride HD + kPad; rows at or past S become zeros.
// Consecutive threads read consecutive 16-byte chunks of a row.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          size_t row_stride, int row0, int n,
                                          int S) {
  constexpr int kChunks = HD / 4;
  for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int d = (e % kChunks) * 4;
    const int s = row0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (s < S) {
      raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(s) * row_stride + d);
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + kPad) + d) = raw;
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KV, float scale, int causal, int window,
                 int prefix_len) {
  constexpr int LD = HD + kPad;          // row stride of q, k, v in smem
  constexpr int LP = kBK + kPad;         // row stride of P in smem
  // float4 output chunks per thread: the 16 tx threads cover HD / 4
  // float4 columns, 64 floats a pass; at HD 80 and 112 the last pass is
  // partial and only tx < (HD % 64) / 4 take part
  constexpr int kM = (HD + 63) / 64;
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
  const float* qb = q + static_cast<size_t>(b) * S * q_row
                    + static_cast<size_t>(h) * HD;
  const float* kb = k + static_cast<size_t>(b) * S * kv_row
                    + static_cast<size_t>(kvh) * HD;
  const float* vb = v + static_cast<size_t>(b) * S * kv_row
                    + static_cast<size_t>(kvh) * HD;
  float* ob = o + static_cast<size_t>(b) * S * q_row
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
          if (64 * i + 4 * tx >= HD) continue;
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
    float* dst = ob + static_cast<size_t>(qi) * q_row;
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      if (64 * i + 4 * tx >= HD) continue;
      const float4 a = acc[r][i];
      *reinterpret_cast<float4*>(dst + 64 * i + 4 * tx) =
          make_float4(a.x / inv, a.y / inv, a.z / inv, a.w / inv);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, float scale, int causal, int window,
                int prefix_len, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + kTcBQ - 1) / kTcBQ);
  flash_kernel_tc<HD><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, KV, scale * kLog2e, causal, window, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, float scale, int causal, int window,
               int prefix_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel_f32<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, scale,
      causal, window, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int is_bf16, float scale, int causal,
           int window, int prefix_len, cudaStream_t stream) {
  return is_bf16
      ? launch_bf16<HD>(q, k, v, o, B, S, H, KV, scale, causal, window,
                        prefix_len, stream)
      : launch_f32<HD>(q, k, v, o, B, S, H, KV, scale, causal, window,
                       prefix_len, stream);
}

}  // namespace

// q, o (B, S, H, hd); k, v (B, S, KV, hd); all contiguous, of one dtype
// (is_bf16 != 0: bf16, else f32), 16-byte aligned; hd in {64, 80, 112,
// 128, 256};
// H % KV == 0; B, S, H and KV positive (the wrapper never passes an empty
// tensor). window <= 0 means no window. Returns cudaGetLastError() after
// the launch, or the error of the shared-memory opt-in.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int hd, int is_bf16,
                                      float scale, int causal, int window,
                                      int prefix_len, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, S, H, KV, is_bf16, scale, causal,
                        window, prefix_len, s);
    case 80:
      return launch<80>(q, k, v, o, B, S, H, KV, is_bf16, scale, causal,
                        window, prefix_len, s);
    case 112:
      return launch<112>(q, k, v, o, B, S, H, KV, is_bf16, scale, causal,
                         window, prefix_len, s);
    case 128:
      return launch<128>(q, k, v, o, B, S, H, KV, is_bf16, scale, causal,
                         window, prefix_len, s);
    case 256:
      return launch<256>(q, k, v, o, B, S, H, KV, is_bf16, scale, causal,
                         window, prefix_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
