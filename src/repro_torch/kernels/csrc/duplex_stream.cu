// Duplex KV-stream kernels for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by repro_torch/kernels/duplex_stream.py).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/duplex_stream.py:
//   duplex_kernel  <- duplex_kv_stream (fused)  (_duplex_kernel, pallas_call :157)
//   quant_kernel   <- quant_stream              (_quant_kernel,  pallas_call :111)
//   dequant_kernel <- dequant_stream            (_dequant_kernel, pallas_call :93)
//
// What they compute, per row (n, t) of D elements:
//   page-in  (dequant): in_deq = bf16_rn(float(in_q) * in_scale)
//   page-out (quant):   scale  = max(amax|x|, 1e-8) / 127
//                       out_q  = clip(rint(x / scale), -127, 127)   (int8)
// The arithmetic is the reference's exactly: a true IEEE divide for the
// scale, codes equal to rint of a true IEEE divide (see code_of; nvcc's
// default -prec-div=true, never --use_fast_math), round half to even, and
// a round-to-nearest bf16 store. Every output element depends on its own
// input element and its row's scale only, so the fused kernel and the two
// halves agree bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Per row of the fused pass the
// kernel reads D (int8) + 4 (scale) + 2D (bf16) bytes and writes 2D (bf16)
// + D (int8) + 4 (scale) bytes, i.e. 6D + 8 bytes for flops-free
// elementwise work plus one max-reduction; at the serving pool's shape
// (N, T, D) = (4, 16, 11520) that is 4.4 MB, 1.32 us at the roofline. At
// that size the time is latency: HBM covers its ~0.7 us round trip only
// with ~18 KB of loads in flight on every SM, in both directions at once.
//
// Design. Where D % 16 == 0 and the pointers are 16-byte aligned (every
// serving shape), each row and direction takes `parts` 512-thread blocks
// (1, 2 or 4: the most that keep the launch to one wave of two blocks an
// SM, duplex_stream.py's `geometry`): the serving shape's 64 rows each way
// are 256 blocks, the fused grid interleaving page-in and page-out rows,
// so reads and writes of both streams are in flight on the SMs together --
// the TPU kernel's double-buffered two-stream pipeline, expressed as
// concurrent blocks. Otherwise a row takes one block and plain element
// loops (the scalar path). A unit is 16 elements. A warp takes spans of
// 32 units; its 16-byte accesses are lane-contiguous on both the int8 and
// the bf16 side (a lane's int8 unit is two other lanes' bf16 chunks: warp
// shuffles carry the codes across), and every warp issues the loads of
// all its spans (up to kStage; a 23 KB row is 1.4 spans a warp) before it
// uses any. Quantizing is the page-out half's cost, so a page-out part
// reads its whole row, keeps it in registers for the amax (HBM is read
// once: the parts' reads of a row meet in L2; a row beyond kStage spans a
// warp, D > 32768, reads its remainder again) and quantizes only its share
// of the spans: a row's quantizing spreads over `parts` SMs with no
// exchange between them (a cluster exchange of the amax cost more than it
// saved). The codes come from the row's reciprocal (code_of), with a true
// divide only next to a half-integer: the divide is a called subroutine
// on this card and cost the page-out half most of its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// blocks an SM must hold (at most 64 registers a thread): the one wave of
// duplex_stream.py's `geometry` (WAVE_BLOCKS) counts on it
constexpr int kBlocksPerSM = 2;
// spans of 32 units a warp holds in registers
constexpr int kStage = 4;

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// the running max of |x| over 8 bf16 values, kept as two 16-bit halves:
// a bf16's magnitude bits order like the magnitudes themselves (finite
// values), so one masked 16x2 integer max takes two values at a time
__device__ __forceinline__ uint32_t amax8(const uint4& v, uint32_t m) {
  constexpr uint32_t kMag = 0x7fff7fffu;
  m = __vmaxu2(m, v.x & kMag);
  m = __vmaxu2(m, v.y & kMag);
  m = __vmaxu2(m, v.z & kMag);
  return __vmaxu2(m, v.w & kMag);
}

// the larger of the two halves of amax8's running max, as an f32
__device__ __forceinline__ float amax_value(uint32_t m) {
  return bf_lo(max(m & 0xffffu, m >> 16));
}

// The int8 code of x: rint(x / s), taken from the row's reciprocal
// r = 1 / s (a true divide, once a row) as rint(x * r), the rounding to an
// integer done by adding 1.5 * 2^23 (round half to even; the code is the
// low byte of the sum's bits). |x| <= amax = 127 s, so |x / s| <= 127 and
// the clip to +-127 never binds: x * r lies within 2^-16 of x / s (two
// roundings of 2^-24 at |x / s| < 128), so rint(x * r) is at most 127 too,
// and the two round alike unless x * r is within 2^-14 of a half-integer:
// then `tie` is set and the caller divides (code_exact), which keeps every
// code bit-equal to rint(x / s) under a true IEEE divide, clipped.
__device__ __forceinline__ uint32_t code_of(float x, float r, bool& tie) {
  const float q = x * r;
  const float t = q + 12582912.0f;
  tie |= fabsf(q - (t - 12582912.0f)) > 0.5f - 0x1p-14f;
  return __float_as_uint(t);
}

__device__ __forceinline__ uint32_t code_exact(float x, float s) {
  const float v = fminf(fmaxf(rintf(x / s), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(v));
}

// the low bytes of a, b, c and d as one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// 8 bf16 values -> their 8 int8 codes, in order, in two words
__device__ __forceinline__ uint2 quant8(const uint4& v, float s, float r) {
  const float x[8] = {bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y),
                      bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w)};
  uint32_t c[8];
  bool tie = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = code_of(x[k], r, tie);
  if (tie) {
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = code_exact(x[k], s);
  }
  return make_uint2(pack4(c[0], c[1], c[2], c[3]),
                    pack4(c[4], c[5], c[6], c[7]));
}

__device__ __forceinline__ float code(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

__device__ __forceinline__ uint32_t deq2(uint32_t w, int i, float s) {
  __nv_bfloat162 v = __floats2bfloat162_rn(code(w, i) * s,
                                           code(w, i + 1) * s);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 int8 codes in two words -> 8 bf16 values, in order
__device__ __forceinline__ uint4 dequant8(uint32_t w0, uint32_t w1, float s) {
  return make_uint4(deq2(w0, 0, s), deq2(w0, 2, s), deq2(w1, 0, s),
                    deq2(w1, 2, s));
}

__device__ __forceinline__ uint32_t shfl(uint32_t v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

// Block-wide max of non-negative values; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    }
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

// --- the 16-byte path: units of 16 elements, D % 16 == 0 ----------------
//
// A warp takes a span of 32 units (512 elements) at unit s of the row. Its
// accesses are 16 bytes a lane and lane-contiguous on both sides: on the
// bf16 side lane L holds chunks 2s + L and 2s + 32 + L (8 values each), on
// the int8 side unit s + L (16 codes). Warp shuffles carry the codes
// between the two layouts.

// the int8 unit of lane L from the quantized bf16 chunks of the span:
// chunks 2L and 2L + 1 (lanes 2L, 2L + 1 of `a` below 16, of `b` above)
__device__ __forceinline__ uint4 gather_codes(uint2 qa, uint2 qb, int lane) {
  const int src = (2 * lane) & 31;
  const uint32_t a0 = shfl(qa.x, src), a1 = shfl(qa.y, src);
  const uint32_t a2 = shfl(qa.x, src + 1), a3 = shfl(qa.y, src + 1);
  const uint32_t b0 = shfl(qb.x, src), b1 = shfl(qb.y, src);
  const uint32_t b2 = shfl(qb.x, src + 1), b3 = shfl(qb.y, src + 1);
  return lane < 16 ? make_uint4(a0, a1, a2, a3) : make_uint4(b0, b1, b2, b3);
}

__device__ __forceinline__ void quant_span(uint4* __restrict__ q, int s,
                                           int hi, uint4 a, uint4 b, float sc,
                                           float r, int lane) {
  const uint4 codes =
      gather_codes(quant8(a, sc, r), quant8(b, sc, r), lane);
  if (s + lane < hi) q[s + lane] = codes;
}

__device__ __forceinline__ void load_span(const uint4* __restrict__ x, int s,
                                          int hi, int lane, uint4& a,
                                          uint4& b) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int c = 2 * s + lane;
  a = c < 2 * hi ? x[c] : zero;
  b = c + 32 < 2 * hi ? x[c + 32] : zero;
}

// where part `part` of `parts` (a power of two) of `n` items starts: a
// shift, not a division (a 64-bit divide costs hundreds of instructions)
__device__ __forceinline__ int share(int n, int part, int parts) {
  return static_cast<int>((static_cast<unsigned long long>(n) * part)
                          >> (__ffs(parts) - 1));
}

// Page-out of part `part` of one row of `units` 16-element units: the
// amax of the whole row (every part reads all of it; the parts' reads of a
// row meet in L2), then the codes of the part's spans.
__device__ __forceinline__ void quant_row_vec(
    const __nv_bfloat16* __restrict__ xrow, int8_t* __restrict__ qrow,
    float* __restrict__ scale, int units, int part, int parts, float* red) {
  const uint4* x = reinterpret_cast<const uint4*>(xrow);
  uint4* q = reinterpret_cast<uint4*>(qrow);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint4 a[kStage], b[kStage];
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int s = 32 * (warp + i * kWarps);
    if (s < units) load_span(x, s, units, lane, a[i], b[i]);
  }
  uint32_t m = 0u;
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    if (32 * (warp + i * kWarps) < units) m = amax8(b[i], amax8(a[i], m));
  }
  // a row beyond the registers: the rest is read again below
  for (int s = 32 * (warp + kStage * kWarps); s < units; s += 32 * kWarps) {
    uint4 ra, rb;
    load_span(x, s, units, lane, ra, rb);
    m = amax8(rb, amax8(ra, m));
  }
  const float sc = fmaxf(block_max(amax_value(m), red), 1e-8f) / 127.0f;
  const float r = 1.0f / sc;
  const int spans = (units + 31) / 32;
  const int lo = share(spans, part, parts), hi = share(spans, part + 1, parts);
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int k = warp + i * kWarps;
    if (k >= lo && k < hi) quant_span(q, 32 * k, units, a[i], b[i], sc, r,
                                      lane);
  }
  for (int k = warp + kStage * kWarps; k < hi; k += kWarps) {
    if (k < lo) continue;
    uint4 ra, rb;
    load_span(x, 32 * k, units, lane, ra, rb);
    quant_span(q, 32 * k, units, ra, rb, sc, r, lane);
  }
  if (part == 0 && threadIdx.x == 0) *scale = sc;
}

// Page-in of part `part` of one row, kStage spans a warp loaded before any
// is converted.
__device__ __forceinline__ void dequant_row_vec(
    const int8_t* __restrict__ qrow, float sc,
    __nv_bfloat16* __restrict__ orow, int units, int part, int parts) {
  const uint4* q = reinterpret_cast<const uint4*>(qrow);
  uint4* out = reinterpret_cast<uint4*>(orow);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // bf16 chunk L of a span is half (L & 1) of unit L / 2, chunk 32 + L
  // half (L & 1) of unit 16 + L / 2
  const int half = lane & 1;
  const int spans = (units + 31) / 32;
  const int hi = share(spans, part + 1, parts);
  for (int k0 = share(spans, part, parts) + warp; k0 < hi;
       k0 += kStage * kWarps) {
    uint4 c[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int s = 32 * (k0 + i * kWarps);
      c[i] = k0 + i * kWarps < hi && s + lane < units
                 ? q[s + lane] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int s = 32 * (k0 + i * kWarps);
      if (k0 + i * kWarps >= hi) break;
      uint32_t w[2][2];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int src = 16 * g + (lane >> 1);
        const uint32_t x0 = shfl(c[i].x, src), x1 = shfl(c[i].y, src);
        const uint32_t x2 = shfl(c[i].z, src), x3 = shfl(c[i].w, src);
        w[g][0] = half ? x2 : x0;
        w[g][1] = half ? x3 : x1;
      }
      const int ch = 2 * s + lane;
      if (ch < 2 * units) out[ch] = dequant8(w[0][0], w[0][1], sc);
      if (ch + 32 < 2 * units) out[ch + 32] = dequant8(w[1][0], w[1][1], sc);
    }
  }
}

// --- the scalar path: ragged D or unaligned pointers, one block a row ---
//
// No serving shape takes it (the pools' D is a multiple of 16): two passes
// over the row, one element a thread at a time.

__device__ __forceinline__ void quant_row_scalar(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
    float* __restrict__ scale, int d, float* red) {
  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    amax = fmaxf(amax, fabsf(__bfloat162float(x[i])));
  }
  const float sc = fmaxf(block_max(amax, red), 1e-8f) / 127.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    q[i] = static_cast<int8_t>(code_exact(__bfloat162float(x[i]), sc));
  }
  if (threadIdx.x == 0) *scale = sc;
}

__device__ __forceinline__ void dequant_row_scalar(
    const int8_t* __restrict__ q, float sc, __nv_bfloat16* __restrict__ out,
    int d) {
  for (int i = threadIdx.x; i < d; i += kThreads) {
    out[i] = __float2bfloat16_rn(static_cast<float>(q[i]) * sc);
  }
}

template <bool kVec>
__device__ __forceinline__ void quant_row(const __nv_bfloat16* __restrict__ x,
                                          int8_t* __restrict__ q,
                                          float* __restrict__ scale, int d,
                                          int part, int parts, float* red) {
  if constexpr (kVec) {
    quant_row_vec(x, q, scale, d / 16, part, parts, red);
  } else {
    quant_row_scalar(x, q, scale, d, red);
  }
}

template <bool kVec>
__device__ __forceinline__ void dequant_row(const int8_t* __restrict__ q,
                                            float sc,
                                            __nv_bfloat16* __restrict__ out,
                                            int d, int part, int parts) {
  if constexpr (kVec) {
    dequant_row_vec(q, sc, out, d / 16, part, parts);
  } else {
    dequant_row_scalar(q, sc, out, d);
  }
}

// block b: c = b / parts is the page-out of row c / 2 when c is odd, its
// page-in when c is even; b % parts is the part of the row
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    duplex_kernel(const int8_t* __restrict__ in_q,
                  const float* __restrict__ in_scale,
                  const __nv_bfloat16* __restrict__ out_x,
                  __nv_bfloat16* __restrict__ in_deq,
                  int8_t* __restrict__ out_q, float* __restrict__ out_scale,
                  int d, int parts) {
  __shared__ float red[kWarps + 1];
  const int part = blockIdx.x % parts;
  const size_t c = blockIdx.x / parts;
  const size_t row = c >> 1;
  const size_t off = row * static_cast<size_t>(d);
  if (c & 1) {
    quant_row<kVec>(out_x + off, out_q + off, out_scale + row, d, part,
                    parts, red);
  } else {
    dequant_row<kVec>(in_q + off, in_scale[row], in_deq + off, d, part,
                      parts);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scale, int d, int parts) {
  __shared__ float red[kWarps + 1];
  const size_t row = blockIdx.x / parts;
  const size_t off = row * static_cast<size_t>(d);
  quant_row<kVec>(x + off, q + off, scale + row, d, blockIdx.x % parts,
                  parts, red);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    dequant_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int d, int parts) {
  const size_t row = blockIdx.x / parts;
  const size_t off = row * static_cast<size_t>(d);
  dequant_row<kVec>(q + off, scale[row], out + off, d, blockIdx.x % parts,
                    parts);
}

}  // namespace

// C interface. ``rows`` = N * T (below 2^30), ``d`` = D; every pointer is
// a contiguous device buffer of the documented dtype; ``stream`` is a
// cudaStream_t. ``vec`` != 0 takes 16-element units (D % 16 == 0, every
// pointer 16-byte aligned: the wrapper checks) and may cut each row into
// ``parts`` (1, 2 or 4) blocks a direction; ``vec`` == 0 takes one
// element at a time and ``parts`` == 1 (duplex_stream.py's ``geometry``). Each returns cudaGetLastError() right after its launch
// (0 = launched).

namespace {

bool valid(long long rows, int d, int vec, int parts) {
  return rows < (1LL << 30) && d >= 1 && !(vec && d % 16)
         && (parts == 1 || (vec && (parts == 2 || parts == 4)));
}

}  // namespace

extern "C" int duplex_kv_stream_launch(const void* in_q, const void* in_scale,
                                       const void* out_x, void* in_deq,
                                       void* out_q, void* out_scale,
                                       long long rows, int d, int vec,
                                       int parts, void* stream) {
  if (rows <= 0) return 0;
  if (!valid(rows, d, vec, parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vec ? &duplex_kernel<true> : &duplex_kernel<false>;
  kernel<<<static_cast<unsigned>(2 * rows * parts), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(in_q), static_cast<const float*>(in_scale),
      static_cast<const __nv_bfloat16*>(out_x),
      static_cast<__nv_bfloat16*>(in_deq), static_cast<int8_t*>(out_q),
      static_cast<float*>(out_scale), d, parts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quant_stream_launch(const void* x, void* q, void* scale,
                                   long long rows, int d, int vec, int parts,
                                   void* stream) {
  if (rows <= 0) return 0;
  if (!valid(rows, d, vec, parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vec ? &quant_kernel<true> : &quant_kernel<false>;
  kernel<<<static_cast<unsigned>(rows * parts), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), d, parts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequant_stream_launch(const void* q, const void* scale,
                                     void* out, long long rows, int d,
                                     int vec, int parts, void* stream) {
  if (rows <= 0) return 0;
  if (!valid(rows, d, vec, parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vec ? &dequant_kernel<true> : &dequant_kernel<false>;
  kernel<<<static_cast<unsigned>(rows * parts), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), d, parts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* duplex_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
