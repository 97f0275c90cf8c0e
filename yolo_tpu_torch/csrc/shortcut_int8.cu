// K3, the fused int8 shortcut: one requantized shortcut of the int8 engine
// in one pass over its two int8 edges.
//
// Replaces no TPU kernel. The JAX package leaves this chain to XLA
// (yolo_tpu/models/int8_engine.py shortcut_i8), which fuses its elementwise
// operations into one loop; eager PyTorch ran it as about 35 kernels over
// full f32 tensors a shortcut. Same contract as the plain twin
// yolo_tpu_torch/ops/shortcut_int8.py::fused_shortcut_int8_reference, per
// element:
//   x  = f32(x8) * sx,  a = f32(a8) * sa
//   xq = rha(x * inv_in) * in_s,  aq = rha(a * inv_in) * in_s
//        (way 2 clamps rha(...) to [qmin, qmax] before the multiply)
//   s  = xq + aq   (nx > na: the channels past na carry xq alone;
//                   nx < na: a is cut to nx channels)
//   r  = clamp(rha(s * inv_sc)),  x' = r * sc
//   q  = int8(clamp(rha(x' * inv_sc)))
// with rha round half away from zero, clamp to [qmin, qmax], x8 (pixels, nx)
// and a8 (pixels, na) int8 NHWC, q (pixels, nx), and the six scales f32
// scalars that the wrapper rounds as PyTorch rounds a scalar operand.
//
// What bounds it on an H100: bytes. Two int8 tensors are read and one
// written, 3 bytes an element: the 23 shortcuts of yolov3 @608 at bs=8 move
// 745.2 MB, 0.2225 ms at 3.35 TB/s. That leaves about 30 instructions an
// element at the card's 128 a clock an SM, fewer than the chain takes
// written out per element (about 40 with its four roundings: 46% of the
// bound on the card). So the kernel runs each step once for every value
// it can take, not once for every element: xq and aq are functions of an
// int8 code (256 values each), and q of the integer r (at most 256 values).
// A block first runs the chain's own steps for every code into three
// tables in shared memory (2.5 KB); then an element costs two table reads,
// the f32 add s = xq + aq, the multiply, clamp and rounding that give r,
// and a byte read of q: about 20 instructions. Every step of the chain
// still runs, in the same order and rounding, the final requant too.
// Clamping before rounding r is exact: rha is monotone and keeps the
// integer bounds. Then |s * inv_sc| <= 128, so floor(w) of w = |v| + 0.5 is
// the low byte of w + 2^23 rounded toward zero, which with v's sign bit
// indexes q's table.
// Design: a grid-stride loop over V-byte pieces of the output (V = 16 where
// the widths and the pointers allow, else 8, 4 or 1), each thread loading
// its pieces of both edges with vector loads and storing one vector; no
// tensor cores. Where nx == na (every yolov3 and yolov4 shortcut) the
// tensors are one flat run and a piece of a is the same piece of x, found
// without a division.
//
// Numerics: every multiply and add is a separate IEEE operation
// (__fmul_rn / __fadd_rn; the build passes --fmad=false), as the twin's
// separate PyTorch kernels are, so the int8 results equal the twin's bit for
// bit, for any scales.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kErrArgs = -1;
constexpr float kTwo23 = 8388608.0f;          // 2^23

struct Chain {
  float sx, sa, inv_in, in_s, inv_sc, sc, lo, hi;
  int way;
};

template <int V> struct Piece;
template <> struct Piece<16> { using T = uint4; };
template <> struct Piece<8> { using T = uint2; };
template <> struct Piece<4> { using T = uint32_t; };
template <> struct Piece<1> { using T = uint8_t; };

// sign(v) * floor(|v| + 0.5), as the twin rounds
__device__ __forceinline__ float rha(float v) {
  return copysignf(floorf(__fadd_rn(fabsf(v), 0.5f)), v);
}

__device__ __forceinline__ float clampf(float v, const Chain& c) {
  return fminf(fmaxf(v, c.lo), c.hi);
}

// one edge's int8 code b dequantized by s, then fake-quantized to the
// shortcut's input scale
__device__ __forceinline__ float edge(float b, float s, const Chain& c) {
  float r = rha(__fmul_rn(__fmul_rn(b, s), c.inv_in));
  if (c.way == 2) r = clampf(r, c);
  return __fmul_rn(r, c.in_s);
}

// A block's tables: tx[b] and ta[b] = xq and aq of the int8 code b
// (indexed by its byte); tq[(neg << 8) | f] = the int8 code of r = -f or
// +f (r in [qmin, qmax]; no other entry is read)
struct Tables {
  float tx[256];
  float ta[256];
  uint8_t tq[512];
};

__device__ void build_tables(Tables& t, const Chain& c) {
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    const float b = static_cast<float>(static_cast<int8_t>(i));
    t.tx[i] = edge(b, c.sx, c);
    t.ta[i] = edge(b, c.sa, c);
  }
  for (int i = threadIdx.x; i < 512; i += kThreads) {
    const float r = i < 256 ? static_cast<float>(i)
                            : -static_cast<float>(i - 256);
    const float q = clampf(rha(__fmul_rn(__fmul_rn(r, c.sc), c.inv_sc)), c);
    t.tq[i] = static_cast<uint8_t>(static_cast<int8_t>(q));
  }
  __syncthreads();
}

// the output code of the sum s: r = rha(clamp(s * inv_sc)), |r| the low
// byte of (|v| + 0.5) + 2^23 rounded toward zero, its sign v's sign bit
__device__ __forceinline__ uint32_t out_code(float s, const Chain& c,
                                             const Tables& t) {
  const float v = clampf(__fmul_rn(s, c.inv_sc), c);
  const float w = __fadd_rz(__fadd_rn(fabsf(v), 0.5f), kTwo23);
  return t.tq[(__float_as_uint(w) & 0xFFu)
              | ((__float_as_uint(v) >> 23) & 0x100u)];
}

// four outputs from four bytes of x and (where `both`) of a
__device__ __forceinline__ uint32_t word(uint32_t xw, uint32_t aw, bool both,
                                         const Chain& c, const Tables& t) {
  uint32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s = t.tx[__byte_perm(xw, 0, 0x4440 + k)];
    if (both) s = __fadd_rn(s, t.ta[__byte_perm(aw, 0, 0x4440 + k)]);
    q[k] = out_code(s, c, t);
  }
  // the low bytes of q[0..3], in order
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                     __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// pieces: V-byte pieces of the output; cx and ca: pieces a pixel of x and of
// a (cx == ca: one flat run, a's piece is x's); cn: the pieces a pixel
// where both edges have channels
template <int V>
__global__ void __launch_bounds__(kThreads)
shortcut_int8_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ a, int8_t* __restrict__ out,
                     long long pieces, long long cx, long long ca,
                     long long cn, Chain c) {
  __shared__ Tables t;
  build_tables(t, c);
  using T = typename Piece<V>::T;
  const T* const xv = reinterpret_cast<const T*>(x);
  const T* const av = reinterpret_cast<const T*>(a);
  T* const ov = reinterpret_cast<T*>(out);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < pieces; i += step) {
    long long ai = i;
    bool both = true;
    if (cx != ca) {
      const long long p = i / cx;
      const long long j = i - p * cx;
      ai = p * ca + j;
      both = j < cn;
    }
    if constexpr (V >= 4) {
      union Words {
        T v;
        uint32_t w[V / 4];
      } xb, ab, ob;
      xb.v = xv[i];
      ab.v = both ? av[ai] : T{};
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        ob.w[k] = word(xb.w[k], ab.w[k], both, c, t);
      }
      ov[i] = ob.v;
    } else {
      float s = t.tx[xv[i]];
      if (both) s = __fadd_rn(s, t.ta[av[ai]]);
      ov[i] = static_cast<T>(out_code(s, c, t));
    }
  }
}

// the blocks that are resident on every SM of `dev` at once (cached per
// device: the host's time a call is part of every caller's wait), so that
// no block of the grid-stride loop waits for a second wave; 0 where it
// cannot be asked
template <int V>
int resident_blocks(int dev) {
  static std::atomic<int> cached[kMaxDevices];   // zero at start
  if (dev < kMaxDevices) {
    const int n = cached[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, shortcut_int8_kernel<V>, kThreads, 0) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess) {
    return 0;
  }
  if (dev < kMaxDevices) {
    cached[dev].store(per_sm * sms, std::memory_order_relaxed);
  }
  return per_sm * sms;
}

template <int V>
int launch(const void* x, const void* a, void* out, long long pixels, int nx,
           int na, const Chain& c, int dev, cudaStream_t s) {
  const int resident = resident_blocks<V>(dev);
  if (resident == 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  long long pieces, cx, ca, cn;
  if (nx == na) {                 // one flat run of pixels * nx elements
    pieces = pixels * nx / V;
    cx = ca = cn = pieces;
  } else {
    cx = nx / V;
    ca = na / V;
    cn = (nx < na ? nx : na) / V;
    pieces = pixels * cx;
  }
  const long long want = (pieces + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < resident ? want : resident);
  shortcut_int8_kernel<V><<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(a),
      static_cast<int8_t*>(out), pieces, cx, ca, cn, c);
  return static_cast<int>(cudaGetLastError());
}

// the widest piece that divides the run (nx == na) or both widths, and
// that every pointer is aligned to
int piece_bytes(const void* x, const void* a, const void* out,
                long long pixels, int nx, int na) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x)
                         | reinterpret_cast<uintptr_t>(a)
                         | reinterpret_cast<uintptr_t>(out);
  for (int v : {16, 8, 4}) {
    const bool fits = nx == na ? (pixels * nx) % v == 0
                               : (nx % v == 0 && na % v == 0);
    if (fits && addr % v == 0) return v;
  }
  return 1;
}

}  // namespace

extern "C" {

// x: int8 (pixels, nx); a: int8 (pixels, na); out: int8 (pixels, nx); all
// contiguous on CUDA device `device`. The six scales are the twin's f32
// scalars (inv_in = f32(1 / in_scale), inv_sc = f32(1 / sc)); way 1 or 2;
// -128 <= qmin <= qmax <= 127. Launches on `stream` (a stream of `device`)
// and returns cudaGetLastError() (0 on success), or -1 for arguments it
// refuses before the launch.
int shortcut_int8_launch(const void* x, const void* a, void* out,
                         long long pixels, int nx, int na, float sx, float sa,
                         float inv_in, float in_s, float inv_sc, float sc,
                         int way, int qmin, int qmax, int device,
                         void* stream) {
  if (pixels < 0 || nx < 0 || na <= 0 || (way != 1 && way != 2)
      || qmin < -128 || qmax > 127 || qmin > qmax) {
    return kErrArgs;
  }
  if (pixels == 0 || nx == 0) return 0;
  int cur = 0;
  if (cudaGetDevice(&cur) != cudaSuccess
      || (cur != device && cudaSetDevice(device) != cudaSuccess)) {
    return static_cast<int>(cudaGetLastError());
  }
  const Chain c{sx, sa, inv_in, in_s, inv_sc, sc, static_cast<float>(qmin),
                static_cast<float>(qmax), way};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (piece_bytes(x, a, out, pixels, nx, na)) {
    case 16: err = launch<16>(x, a, out, pixels, nx, na, c, device, s); break;
    case 8: err = launch<8>(x, a, out, pixels, nx, na, c, device, s); break;
    case 4: err = launch<4>(x, a, out, pixels, nx, na, c, device, s); break;
    default: err = launch<1>(x, a, out, pixels, nx, na, c, device, s); break;
  }
  if (cur != device) cudaSetDevice(cur);
  return err;
}

const char* shortcut_int8_error_string(int err) {
  if (err == kErrArgs) {
    return "the sizes, the way or the int8 range are outside what the "
           "kernel takes";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
