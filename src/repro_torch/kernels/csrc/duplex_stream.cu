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
// The arithmetic is the reference's exactly: a true IEEE divide (nvcc's
// default -prec-div=true; never build with --use_fast_math), round half to
// even (rintf), and a round-to-nearest bf16 store.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Per row of the fused pass the
// kernel reads D (int8) + 4 (scale) + 2D (bf16) bytes and writes 2D (bf16)
// + D (int8) + 4 (scale) bytes, i.e. 6D + 8 bytes for 2D flops-free
// elementwise ops plus one max-reduction; at the serving pool's shapes
// (T = 16, D = 11520) one pair of 2-block stage slabs is 2.2 MB, ~0.66 us
// at the memory roofline.
//
// Design: one thread block per row and direction. The fused grid interleaves
// the two directions block by block (even blocks dequantize page-ins, odd
// blocks quantize page-outs), so both streams are in flight on the SMs
// together and the read and write directions of HBM stay busy at once --
// the TPU kernel's double-buffered two-stream pipeline, expressed as
// concurrent blocks instead of sequential grid steps. The quant half makes
// two passes over its row: a block-wide amax (warp shuffles, then one
// shared-memory hop across warps), then the divide-and-round pass, whose
// re-read of the 23 KB row is served from L1/L2. Staged TMA slabs are the
// next step (the kernel is simple and right first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ void quant_row(const __nv_bfloat16* __restrict__ x,
                                          int8_t* __restrict__ q,
                                          float* __restrict__ scale, int d,
                                          float* red) {
  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    amax = fmaxf(amax, fabsf(__bfloat162float(x[i])));
  }
  amax = block_max(amax, red);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float v = rintf(__bfloat162float(x[i]) / s);
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    q[i] = static_cast<int8_t>(v);
  }
  if (threadIdx.x == 0) *scale = s;
}

__device__ __forceinline__ void dequant_row(const int8_t* __restrict__ q,
                                            float s,
                                            __nv_bfloat16* __restrict__ out,
                                            int d) {
  for (int i = threadIdx.x; i < d; i += kThreads) {
    out[i] = __float2bfloat16_rn(static_cast<float>(q[i]) * s);
  }
}

__global__ void __launch_bounds__(kThreads)
    duplex_kernel(const int8_t* __restrict__ in_q,
                  const float* __restrict__ in_scale,
                  const __nv_bfloat16* __restrict__ out_x,
                  __nv_bfloat16* __restrict__ in_deq,
                  int8_t* __restrict__ out_q, float* __restrict__ out_scale,
                  int d) {
  __shared__ float red[kWarps + 1];
  const size_t row = blockIdx.x >> 1;
  const size_t off = row * static_cast<size_t>(d);
  if (blockIdx.x & 1) {
    quant_row(out_x + off, out_q + off, out_scale + row, d, red);
  } else {
    dequant_row(in_q + off, in_scale[row], in_deq + off, d);
  }
}

__global__ void __launch_bounds__(kThreads)
    quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scale, int d) {
  __shared__ float red[kWarps + 1];
  const size_t row = blockIdx.x;
  const size_t off = row * static_cast<size_t>(d);
  quant_row(x + off, q + off, scale + row, d, red);
}

__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int d) {
  const size_t row = blockIdx.x;
  const size_t off = row * static_cast<size_t>(d);
  dequant_row(q + off, scale[row], out + off, d);
}

}  // namespace

// C interface. ``rows`` = N * T, ``d`` = D; every pointer is a contiguous
// device buffer of the documented dtype; ``stream`` is a cudaStream_t. Each
// returns cudaGetLastError() right after its launch (0 = launched).

extern "C" int duplex_kv_stream_launch(const void* in_q, const void* in_scale,
                                       const void* out_x, void* in_deq,
                                       void* out_q, void* out_scale,
                                       long long rows, int d, void* stream) {
  duplex_kernel<<<static_cast<unsigned>(2 * rows), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(in_q), static_cast<const float*>(in_scale),
      static_cast<const __nv_bfloat16*>(out_x),
      static_cast<__nv_bfloat16*>(in_deq), static_cast<int8_t*>(out_q),
      static_cast<float*>(out_scale), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quant_stream_launch(const void* x, void* q, void* scale,
                                   long long rows, int d, void* stream) {
  quant_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequant_stream_launch(const void* q, const void* scale,
                                     void* out, long long rows, int d,
                                     void* stream) {
  dequant_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* duplex_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
