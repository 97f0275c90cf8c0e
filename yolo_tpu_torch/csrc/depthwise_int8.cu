// K4, the depthwise int8 conv: one int8 conv whose every output channel reads
// its own input channel (groups == Cin == Cout), and K2's f32 epilogue, in
// one launch.
//
// Replaces no TPU kernel. The JAX package leaves this conv to XLA's s8 conv
// (yolo_tpu/models/int8_engine.py); eager PyTorch ran it as the plain twin
// yolo_tpu_torch/ops/depthwise_int8.py::fused_depthwise_int8_reference
// (ops/conv_int8.py grouped_conv_s32 and _epilogue): a cast and a pad of the
// input to int32, one multiply-add pass over the whole output per tap (9 or
// 25), and about 14 more kernels of epilogue, some 35 launches a conv. Same
// contract:
//   acc = sum over (ky, kx) of x[n, oy*sy + ky - py, ox*sx + kx - px, c]
//                              * w[c, ky, kx]                   (exact)
//   y   = act(float(acc) * scale + bias[c])                     (f32)
//   out = clip(round_half_away(y * oinv), qmin, qmax) as int8
// with x int8 NHWC, w int8 (C, K, K, 1) as the engine's plan stores it, zero
// padding (py, px), K odd up to 7, strides 1 or 2, and scale and oinv the
// f32 scalars that the wrapper rounds.
//
// What bounds it on an H100: the 15 depthwise convs of yolov3-mobilenet @640
// at bs=8 move 246.8 MB (0.0737 ms at 3.35 TB/s) and do 1.20 G multiply-adds,
// which have no tensor-core form: at the 64 int32 multiply-adds a clock an
// SM they would take 0.08 ms, at the 128 f32 FMAs 0.04 ms. The epilogue adds
// ~15 ALU instructions on each of 90.3 M outputs. So the kernel reads each
// input byte from device memory about once, keeps the K x K reuse on chip,
// and sums in f32 FMAs.
//
// Design. A thread sums kRun = 4 neighbouring outputs of one row for V
// channels (V = 8 where C % 8 == 0 and the pointers allow, else 1):
// for each of the K input rows it walks the (kRun - 1) * sx + K input
// columns the run reads, loads each column's V codes once (one 8-byte load
// for V = 8), turns them into f32 and adds them into every output of the
// run whose window holds that column, so each loaded column serves up to K
// taps from registers. A block takes `gb` channel groups of V channels (a
// run of gb * V channels, at most 256) and as many runs as fill 256 threads;
// neighbouring threads read neighbouring channels of one pixel, so a warp's
// loads are whole sectors, and the rows and columns the runs of a block
// share come from L1 and L2. The block's weights go into shared memory once,
// as f32, tap-major, so that a thread reads a tap's 8 weights with two
// 16-byte loads. Padding and columns or rows past the edge are zeros, never
// a padded copy of x. The epilogue is K2's, stored as V bytes a pixel (one
// 8-byte store for V = 8).
//
// Numerics: every product of two int8 codes and every partial sum is an
// integer of magnitude at most 49 * 128 * 128 < 2^24, so the f32 FMAs
// (__fmaf_rn) sum exactly, in any order, and acc equals the s32 sum and its
// float(acc). An int8 code b becomes f32 exactly as (2^23 + (b ^ 0x80)) -
// (2^23 + 128): one byte permute into the mantissa of 2^23 and one
// subtraction. The epilogue's multiplies and adds are separate IEEE
// operations (__fmul_rn / __fadd_rn; the build passes --fmad=false), in the
// twin's order. h_swish and h_sigmoid divide by 6 as PyTorch divides a CUDA
// tensor by a Python number: a multiply by the f32 reciprocal. So with
// linear, leaky, relu, relu6, h_swish and h_sigmoid the int8 outputs equal
// the twin's on the card bit for bit; mish, swish and logistic
// (activate_rare, shared with K2) may differ from PyTorch's by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_int8.cuh"   // Act, activate_rare

namespace {

constexpr int kThreads = 256;      // threads a block, at most
constexpr int kRun = 4;            // outputs of a row a thread sums
constexpr int kMaxGroups = 32;     // channel groups a block takes, at most
constexpr int kSmemWeights = 48 * 1024;   // static-limit shared memory
constexpr int kErrArgs = -1;
constexpr float kMagic = 8388736.0f;      // 2^23 + 128
constexpr float kSixth = 1.0f / 6.0f;     // f32(1 / 6), as PyTorch forms it

struct DwArgs {
  const int8_t* x;      // (n, h, wd, c)
  const int8_t* w;      // (c, k, k, 1)
  const float* bias;    // (c,)
  int8_t* out;          // (n, ho, wo, c)
  int h, wd, c, ho, wo, sy, py, px;
  int gb;               // channel groups of V channels a block takes
  int slots;            // runs a block takes
  int runs;             // runs of kRun outputs a row
  long long tasks;      // runs of the whole output: n * ho * runs
  float scale, oinv, slope;
  int act, qmin, qmax;
};

// the f32 value of the int8 code in byte k of a word whose bytes were
// xored with 0x80
__device__ __forceinline__ float code_f32(uint32_t biased, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u,
                                               0x7650 + k)),
                   kMagic);
}

// V codes of channels c .. c + V - 1 at `p` as f32 (zeros where !ok)
template <int V>
__device__ __forceinline__ void load_codes(const int8_t* p, bool ok,
                                           float (&f)[V]) {
  if constexpr (V == 8) {
    const uint2 u = ok ? __ldg(reinterpret_cast<const uint2*>(p))
                       : make_uint2(0u, 0u);
    const uint32_t a = u.x ^ 0x80808080u, b = u.y ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = code_f32(a, k);
      f[4 + k] = code_f32(b, k);
    }
  } else {
    const uint32_t a =
        (ok ? static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(p))
            : 0u) ^ 0x80u;
    f[0] = code_f32(a, 0);
  }
}

// the V f32 weights of one tap at `p` in shared memory (16-byte aligned
// where V == 8)
template <int V>
__device__ __forceinline__ void load_weights(const float* p, float* w) {
  if constexpr (V == 8) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
    w[0] = p[0];
  }
}

// the activation on all N values, with one test of `act` for all of them
template <int N>
__device__ __forceinline__ void activate(float* y, int act, float slope) {
  if (act == kLeaky) {
    // y > 0 ? y : y * slope, as max(y, y * slope) for 0 < slope < 1 (K2's)
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = fmaxf(y[i], __fmul_rn(y[i], slope));
  } else if (act == kRelu) {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = y[i] > 0.0f ? y[i] : 0.0f;
  } else if (act == kRelu6) {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = fminf(fmaxf(y[i], 0.0f), 6.0f);
  } else if (act == kHSwish) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = fminf(fmaxf(__fadd_rn(y[i], 3.0f), 0.0f), 6.0f);
      y[i] = __fmul_rn(y[i], __fmul_rn(t, kSixth));
    }
  } else if (act == kHSigmoid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      y[i] = __fmul_rn(fminf(fmaxf(__fadd_rn(y[i], 3.0f), 0.0f), 6.0f),
                       kSixth);
    }
  } else if (act != kLinear) {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = activate_rare(y[i], act);
  }
}

// requantize V values and store their bytes at `p` (V-byte aligned)
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const float* y,
                                            float oinv, int lo, int hi) {
  int r[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    // round half away from zero, as trunc(v + copysign(0.5, v)) (K2's)
    const float v = __fmul_rn(y[i], oinv);
    r[i] = min(max(__float2int_rz(__fadd_rn(v, copysignf(0.5f, v))), lo), hi);
  }
  if constexpr (V == 8) {
    uint32_t w[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      // the low bytes of r[4q .. 4q + 3], in order
      w[q] = __byte_perm(__byte_perm(r[4 * q], r[4 * q + 1], 0x0040),
                         __byte_perm(r[4 * q + 2], r[4 * q + 3], 0x0040),
                         0x5410);
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = static_cast<int8_t>(r[0]);
  }
}

// Block (bx, by) takes channels by * gb * V .. + gb * V and runs bx * slots
// .. + slots; thread t the channel group t % gb of the block and its run
// t / gb. A run is kRun outputs (n, oy, ox0 .. ox0 + kRun - 1) of one row.
template <int K, int SX, int V>
__global__ void __launch_bounds__(kThreads)
depthwise_int8_kernel(const DwArgs a) {
  extern __shared__ float4 smem[];
  float* const wsm = reinterpret_cast<float*>(smem);   // [K * K][gb * V]
  const int cb = a.gb * V;
  const int c0 = blockIdx.y * cb;
  const int cn = min(cb, a.c - c0);
  for (int i = threadIdx.x; i < cn * K * K; i += blockDim.x) {
    const int cl = i / (K * K);
    const int t = i - cl * (K * K);
    wsm[t * cb + cl] = static_cast<float>(a.w[(c0 + cl) * (K * K) + t]);
  }
  __syncthreads();

  const int g = threadIdx.x % a.gb;
  const int slot = threadIdx.x / a.gb;
  const long long task = static_cast<long long>(blockIdx.x) * a.slots + slot;
  const int c = c0 + g * V;
  if (slot >= a.slots || task >= a.tasks || c >= a.c) return;
  const long long row_task = task / a.runs;
  const int ox0 = static_cast<int>(task - row_task * a.runs) * kRun;
  const int oy = static_cast<int>(row_task % a.ho);
  const int n = static_cast<int>(row_task / a.ho);
  const int ix0 = ox0 * SX - a.px;
  const float* const wg = wsm + g * V;

  float acc[kRun][V];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;
  }
#pragma unroll
  for (int ky = 0; ky < K; ++ky) {
    const int iy = oy * a.sy - a.py + ky;
    if (iy < 0 || iy >= a.h) continue;
    float w[K][V];
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      load_weights<V>(wg + (ky * K + kx) * cb, w[kx]);
    }
    const int8_t* const row =
        a.x + (static_cast<long long>(n) * a.h + iy) * a.wd * a.c + c;
#pragma unroll
    for (int j = 0; j < (kRun - 1) * SX + K; ++j) {
      const int ix = ix0 + j;
      const bool ok = ix >= 0 && ix < a.wd;
      float f[V];
      load_codes<V>(ok ? row + static_cast<long long>(ix) * a.c : row, ok, f);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int kx = j - r * SX;
        if (kx >= 0 && kx < K) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[r][v] = __fmaf_rn(f[v], w[kx][v], acc[r][v]);
          }
        }
      }
    }
  }

  float b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) b[v] = __ldg(a.bias + c + v);
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[r][v] = __fadd_rn(__fmul_rn(acc[r][v], a.scale), b[v]);
    }
  }
  activate<kRun * V>(&acc[0][0], a.act, a.slope);
  int8_t* const out =
      a.out + ((static_cast<long long>(n) * a.ho + oy) * a.wo + ox0) * a.c + c;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (ox0 + r < a.wo) {
      store_codes<V>(out + static_cast<long long>(r) * a.c, acc[r], a.oinv,
                     a.qmin, a.qmax);
    }
  }
}

template <int K, int SX, int V>
int launch(DwArgs a, int n, cudaStream_t s) {
  const int groups = a.c / V;
  // the most groups a block's f32 weights leave room for
  int hi = kSmemWeights / (K * K * V * 4);
  if (hi > kMaxGroups) hi = kMaxGroups;
  int gb = groups;
  if (groups > hi) {
    // the block width in [hi / 2, hi] that leaves the fewest groups idle
    // in the last channel block (the widest of those)
    int waste = groups;
    for (int b = hi; b >= (hi + 1) / 2; --b) {
      const int wb = (groups + b - 1) / b * b - groups;
      if (wb < waste) {
        waste = wb;
        gb = b;
      }
    }
  }
  a.gb = gb;
  a.slots = kThreads / gb;
  a.runs = (a.wo + kRun - 1) / kRun;
  a.tasks = static_cast<long long>(n) * a.ho * a.runs;
  const long long bx = (a.tasks + a.slots - 1) / a.slots;
  const int by = (groups + gb - 1) / gb;
  if (bx > 0x7fffffffLL || by > 65535) return kErrArgs;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  depthwise_int8_kernel<K, SX, V><<<grid, a.slots * gb,
                                    K * K * gb * V * 4, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int SX>
int launch_v(int v, const DwArgs& a, int n, cudaStream_t s) {
  return v == 8 ? launch<K, SX, 8>(a, n, s) : launch<K, SX, 1>(a, n, s);
}

template <int K>
int launch_sx(int sx, int v, const DwArgs& a, int n, cudaStream_t s) {
  return sx == 1 ? launch_v<K, 1>(v, a, n, s) : launch_v<K, 2>(v, a, n, s);
}

}  // namespace

extern "C" {

// x: int8 (n, h, wd, c); w: int8 (c, k, k, 1); bias: f32 (c,); out: int8
// (n, ho, wo, c) with ho = (h + 2 py - k) / sy + 1 >= 1 and wo alike. All
// contiguous on CUDA device `device`. k in {1, 3, 5, 7}, sy and sx in {1,
// 2}, py and px >= 0, -128 <= qmin <= qmax <= 127. Launches on `stream` (a
// stream of `device`) and returns cudaGetLastError() (0 on success), or -1
// for arguments it refuses before the launch.
int depthwise_int8_launch(const void* x, const void* w, const void* bias,
                          void* out, int n, int h, int wd, int c, int k,
                          int sy, int sx, int py, int px, int ho, int wo,
                          float scale, float oinv, int act, float slope,
                          int qmin, int qmax, int device, void* stream) {
  if (n < 0 || h < 0 || wd < 0 || c < 0 || (k != 1 && k != 3 && k != 5
                                             && k != 7)
      || (sy != 1 && sy != 2) || (sx != 1 && sx != 2) || py < 0 || px < 0
      || h + 2 * py < k || wd + 2 * px < k
      || ho != (h + 2 * py - k) / sy + 1 || wo != (wd + 2 * px - k) / sx + 1
      || qmin < -128 || qmax > 127 || qmin > qmax
      || static_cast<long long>(c) * k * k > 0x7fffffffLL) {
    return kErrArgs;
  }
  if (n == 0 || c == 0) return 0;
  // 8 channels a thread, loaded and stored as one 8-byte piece, where the
  // widths and the addresses allow (every cfg's); else one
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x)
                         | reinterpret_cast<uintptr_t>(out);
  const int v = c % 8 == 0 && addr % 8 == 0 ? 8 : 1;
  DwArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<int8_t*>(out);
  a.h = h; a.wd = wd; a.c = c; a.ho = ho; a.wo = wo;
  a.sy = sy; a.py = py; a.px = px;
  a.gb = a.slots = a.runs = 0;
  a.tasks = 0;
  a.scale = scale; a.oinv = oinv; a.slope = slope;
  a.act = act; a.qmin = qmin; a.qmax = qmax;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // launch on `device`, and leave the caller's current device as it was
  int cur = 0;
  if (cudaGetDevice(&cur) != cudaSuccess
      || (cur != device && cudaSetDevice(device) != cudaSuccess)) {
    return static_cast<int>(cudaGetLastError());
  }
  int err;
  switch (k) {
    case 1: err = launch_sx<1>(sx, v, a, n, s); break;
    case 3: err = launch_sx<3>(sx, v, a, n, s); break;
    case 5: err = launch_sx<5>(sx, v, a, n, s); break;
    default: err = launch_sx<7>(sx, v, a, n, s); break;
  }
  if (cur != device) cudaSetDevice(cur);
  return err;
}

const char* depthwise_int8_error_string(int err) {
  if (err == kErrArgs) {
    return "the sizes, the window, the strides, the padding or the int8 "
           "range are outside what the kernel takes";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
