// Fused int8 convolution: s8 x s8 -> s32 implicit GEMM plus the dequantize /
// bias / activation / requantize epilogue.
//
// Replaces yolo_tpu/ops/pallas_conv.py::_kernel (the Pallas TPU kernel behind
// fused_conv_int8, which the int8 engine calls for every conv on an int8
// edge). Same contract:
//   acc = sum over (ky, kx, c) of x[n, oy*s + ky - p, ox*s + kx - p, c]
//                                * w[co, ky, kx, c]            (exact s32)
//   y   = act(float(acc) * scale + bias[co])                  (f32)
//   out = clip(round_half_away(y * oinv), qmin, qmax) as int8  (out_q)
//         or y as f32
// with x int8 NHWC, w int8 (Cout, K, K, Cin), zero padding p = K / 2 and
// oinv = 1 / out_scale computed in f32 by the wrapper. The plain PyTorch twin
// is yolo_tpu_torch/ops/conv_int8.py::fused_conv_int8_reference.
//
// What bounds it on an H100: yolov3 @608 at bs=8 is about 1.12 T int8
// operations (a multiply-add counts two) over its 74 int8 convs, >= 0.57 ms
// at the 1,979 TOP/s of the s8 tensor cores (the data sheet's peak). Most
// 3x3 layers are bound by those operations; the high-resolution 1x1 layers
// are bound by bytes (1x1 at 76 px, 256 -> 128, bs=8: 11.8 MB in, 32 KB of
// weights, 5.9 MB out, >= 5.3 us at 3.35 TB/s against 1.5 us of tensor-core
// time).
// What this first design does: a plain implicit GEMM on the CUDA cores with
// __dp4a (four int8 multiply-adds into an s32 per instruction). Rows of the
// GEMM are output pixels (n, oy, ox) flattened, columns output channels, and
// the reduction runs tap by tap over 32-channel chunks. Each block of 256
// threads computes 128 pixels x 64 channels (8 x 4 per thread, in registers);
// per chunk it stages the A tile (the 32 input channels that each pixel reads
// at this tap, zero outside the image) and the B tile (32 channels of 64
// filters) in shared memory, transposed so that each thread reads its 8 A
// words and 4 B words as 16-byte vectors, and the next chunk's global loads
// are in flight while the current one is summed. Strided windows are indexed
// directly (no space-to-depth). The epilogue runs on the registers and stores
// NHWC directly. On an NVIDIA H100 80GB HBM3 at 700 W this design measured
// 67 TOP/s on the 3x3 layers of yolov3 @608 bs=8 (chip_smoke.py), some 30x
// under the s8 tensor cores: the fast form (wgmma s8 with TMA tiles and a
// persistent tile loop) is later work.
//
// Numerics: the s32 sums are exact in any order. float(acc) rounds to nearest
// even (__int2float_rn, as the reference's int32 -> float32 convert does above
// 2^24), and the multiply and the adds are separate IEEE operations
// (__fmul_rn / __fadd_rn, and the build passes --fmad=false), so with leaky,
// relu or linear the int8 outputs equal the plain version's bit for bit. The
// transcendental activations (mish, swish) may differ from PyTorch's by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // output pixels per block
constexpr int kBN = 64;      // output channels per block
constexpr int kBKW = 8;      // reduction chunk, in 32-bit words (32 int8)
constexpr int kTM = 8;       // pixels per thread
constexpr int kTN = 4;       // channels per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);       // 256
constexpr int kALoads = kBM * kBKW / kThreads;             // 4 words
constexpr int kBLoads = kBN * kBKW / kThreads;             // 2 words
constexpr int kRowStep = kThreads / kBKW;                  // 32
constexpr int kPad = 4;      // keeps the transposed smem stores conflict-free

enum Act {
  kLinear = 0, kLeaky = 1, kRelu = 2, kRelu6 = 3, kMish = 4, kSwish = 5,
  kLogistic = 6, kHSwish = 7, kHSigmoid = 8
};

__device__ __forceinline__ float sigmoidf(float y) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-y)));
}

__device__ __forceinline__ float activate(float y, int act, float slope) {
  switch (act) {
    case kLeaky: return y > 0.0f ? y : __fmul_rn(y, slope);
    case kRelu: return y > 0.0f ? y : 0.0f;
    case kRelu6: return fminf(fmaxf(y, 0.0f), 6.0f);
    case kMish: {   // softplus with PyTorch's threshold of 20
      const float sp = y > 20.0f ? y : log1pf(expf(y));
      return __fmul_rn(y, tanhf(sp));
    }
    case kSwish: return __fmul_rn(y, sigmoidf(y));
    case kLogistic: return sigmoidf(y);
    case kHSwish:
      return __fmul_rn(y, __fdiv_rn(fminf(fmaxf(y + 3.0f, 0.0f), 6.0f), 6.0f));
    case kHSigmoid: return __fdiv_rn(fminf(fmaxf(y + 3.0f, 0.0f), 6.0f), 6.0f);
    default: return y;
  }
}

template <bool kOutQ>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                 const float* __restrict__ bias, void* __restrict__ out,
                 int h, int wd, int cinw, int cout, int k, int stride, int pad,
                 int ho, int wo, long long m_total, float scale, float oinv,
                 int act, float slope, int qmin, int qmax) {
  __shared__ __align__(16) int32_t as[kBKW][kBM + kPad];
  __shared__ __align__(16) int32_t bs[kBKW][kBN + kPad];

  const int tid = threadIdx.x;
  const int tn = tid % (kBN / kTN);
  const int tm = tid / (kBN / kTN);
  const long long m0 = (long long)blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;

  // this thread's loads: word `lw` of the chunk for rows lr + j * kRowStep
  const int lw = tid % kBKW;
  const int lr = tid / kBKW;
  long long a_img[kALoads];
  int a_iy[kALoads], a_ix[kALoads];
#pragma unroll
  for (int j = 0; j < kALoads; ++j) {
    const long long m = m0 + lr + j * kRowStep;
    if (m < m_total) {
      const int ox = (int)(m % wo);
      const long long t = m / wo;
      const int oy = (int)(t % ho);
      a_img[j] = (t / ho) * h;
      a_iy[j] = oy * stride - pad;
      a_ix[j] = ox * stride - pad;
    } else {                       // past the last pixel: always zero
      a_img[j] = 0;
      a_iy[j] = -(1 << 29);
      a_ix[j] = 0;
    }
  }

  const int chunks_c = (cinw + kBKW - 1) / kBKW;
  const int n_chunks = k * k * chunks_c;
  int ra[kALoads], rb[kBLoads];

  auto load = [&](int c) {
    const int tap = c / chunks_c;
    const int ky = tap / k, kx = tap % k;
    const int cw = (c % chunks_c) * kBKW + lw;
    const bool c_ok = cw < cinw;
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      const int iy = a_iy[j] + ky, ix = a_ix[j] + kx;
      ra[j] = (c_ok && iy >= 0 && iy < h && ix >= 0 && ix < wd)
          ? __ldg(x + ((a_img[j] + iy) * wd + ix) * cinw + cw) : 0;
    }
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      const int co = co0 + lr + j * kRowStep;
      rb[j] = (c_ok && co < cout)
          ? __ldg(w + ((long long)(co * k + ky) * k + kx) * cinw + cw) : 0;
    }
  };

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  load(0);
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int j = 0; j < kALoads; ++j) as[lw][lr + j * kRowStep] = ra[j];
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) bs[lw][lr + j * kRowStep] = rb[j];
    __syncthreads();
    if (c + 1 < n_chunks) load(c + 1);    // in flight while this chunk sums
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      const int4 a0 = *reinterpret_cast<const int4*>(&as[kw][tm * kTM]);
      const int4 a1 = *reinterpret_cast<const int4*>(&as[kw][tm * kTM + 4]);
      const int4 b = *reinterpret_cast<const int4*>(&bs[kw][tn * kTN]);
      const int a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float fqmin = (float)qmin, fqmax = (float)qmax;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + tm * kTM + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int co = co0 + tn * kTN + j;
      if (co >= cout) continue;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale),
                          bias[co]);
      y = activate(y, act, slope);
      if (kOutQ) {
        const float v = __fmul_rn(y, oinv);
        float r = copysignf(floorf(__fadd_rn(fabsf(v), 0.5f)), v);
        r = fminf(fmaxf(r, fqmin), fqmax);
        static_cast<int8_t*>(out)[m * cout + co] = (int8_t)(int)r;
      } else {
        static_cast<float*>(out)[m * cout + co] = y;
      }
    }
  }
}

}  // namespace

extern "C" {

// x: int8 (n, h, wd, cin) with cin % 4 == 0; w: int8 (cout, k, k, cin);
// bias: f32 (cout,); out: (n, ho, wo, cout) int8 (out_q) or f32. All
// contiguous, 4-byte aligned, on the current device. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int conv_int8_launch(const void* x, const void* w, const void* bias, void* out,
                     int n, int h, int wd, int cin, int cout, int k,
                     int stride, int pad, int ho, int wo, float scale,
                     float oinv, int act, float slope, int out_q, int qmin,
                     int qmax, void* stream) {
  const long long m_total = (long long)n * ho * wo;
  if (m_total == 0 || cout == 0) return 0;
  if (cin % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long gx = (m_total + kBM - 1) / kBM;
  const int gy = (cout + kBN - 1) / kBN;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* xw = static_cast<const int32_t*>(x);
  const int32_t* ww = static_cast<const int32_t*>(w);
  const float* b = static_cast<const float*>(bias);
  if (out_q) {
    conv_int8_kernel<true><<<grid, kThreads, 0, s>>>(
        xw, ww, b, out, h, wd, cin / 4, cout, k, stride, pad, ho, wo, m_total,
        scale, oinv, act, slope, qmin, qmax);
  } else {
    conv_int8_kernel<false><<<grid, kThreads, 0, s>>>(
        xw, ww, b, out, h, wd, cin / 4, cout, k, stride, pad, ho, wo, m_total,
        scale, oinv, act, slope, qmin, qmax);
  }
  return (int)cudaGetLastError();
}

const char* conv_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
