// Fused int8 convolution: s8 x s8 -> s32 implicit GEMM on Hopper's tensor
// cores, plus the dequantize / bias / activation / requantize epilogue.
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
// What bounds it on an H100: the 74 int8 convs of yolov3 @608 at bs=8 are
// 1.12 T int8 operations (a multiply-add counts two), 0.71 ms at the 1,979
// TOP/s of the s8 tensor cores and the 3.35 TB/s of HBM3 (data sheet peaks).
// The 3x3 layers are bound by those operations; most 1x1 layers, and the
// high-resolution 3x3 layers with 32 input channels, by bytes (1x1 at 76 px,
// 256 -> 128, bs=8: 11.8 MB in, 5.9 MB out, >= 5.3 us against 1.5 us of
// tensor-core time).
//
// Design. An implicit GEMM: rows are output pixels (n, oy, ox) flattened
// across images, so the 19 px layers waste no tile; columns are output
// channels; the reduction runs over the flattened (ky, kx, c) of the OHWI
// weights, K*K*Cin bytes, in stages of 128 bytes. A tile is 128 pixels x BN
// channels (BN = 32, 64, 128 or 256, from the wrapper's tile plan), and a
// persistent block of 384 threads walks its share of the tiles:
// - for the operations: warpgroups 1 and 2 each own 64 of a tile's rows and
//   run wgmma.mma_async m64nBNk32 s32.s8.s8 with both operands in shared
//   memory and the s32 sums in registers (no .satfinite: |acc| <=
//   9*1024*128*128 < 2^31, and the sums stay exact);
// - for the bytes: a ring of 3-4 A/B stages in shared memory keeps loads in
//   flight while the tensor cores sum, and warpgroup 0 fills it, running
//   ahead into the block's next tile while the consumers finish the last
//   one. The weights (B, a plain Cout x K*K*Cin matrix) come by TMA, one
//   128-byte x BN box per stage, zero-filled past the ends. So does A for a
//   1x1 stride-1 conv, where x is a plain (pixels x Cin) matrix. For a 3x3
//   conv the loader threads copy A with 16-byte cp.async at computed
//   addresses: each 16-byte piece of a row lies in one tap (Cin is a
//   multiple of 16), so the copy reads x[n, oy*s + ky - p, ox*s + kx - p,
//   c .. c+15] directly, stride 2 included, and the zero padding of the
//   'same' conv, like rows past the last pixel, is the copy's zero fill
//   (src-size 0), never a padded copy of x. They write the pieces in the
//   128-byte swizzle that TMA gives B and that the wgmma descriptors name.
//   A stage is full when its TMA bytes and the loader threads' copies have
//   landed (one mbarrier), and free again when every consumer warp has
//   finished the wgmma that read it (a second mbarrier);
// - the 128-byte stage packs taps: a layer with 32 input channels sums four
//   taps per stage, and no stage is padded to a tap boundary;
// - the epilogue is ALU work on every output (dequantize, bias, activate,
//   requantize, pack: about a dozen instructions each), as much as the 1x1
//   layers' tensor work, and its code must stay small: it passes the s32
//   sums through shared memory in slabs of 32 channels, and one out-of-line
//   routine turns 16 channels of a row into one 16-byte store (four for
//   f32). Fully unrolled epilogues, one copy per fragment register, were
//   slower in every form tried: their code did not stay in the instruction
//   cache. An int8 output whose Cout is not a multiple of 16 (the heads'
//   255) and that fits one channel tile is built as one run of bytes in
//   shared memory and stored with aligned 16-byte stores; other partial
//   rows in aligned words and bytes.
// There is no split-K (the epilogue is fused).
//
// Numerics: the s32 sums are exact in any order. float(acc) rounds to nearest
// even (__int2float_rn, as the reference's int32 -> float32 convert does above
// 2^24), and the multiply and the adds are separate IEEE operations
// (__fmul_rn / __fadd_rn, and the build passes --fmad=false), so with leaky,
// relu or linear the int8 outputs equal the plain version's bit for bit. The
// transcendental activations (mish, swish) may differ from PyTorch's by an ulp.

#include <cuda.h>            // CUtensorMap and its enums; no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBM = 128;        // output pixels per block
constexpr int kBK = 128;        // reduction bytes per stage (one swizzle row)
constexpr int kThreads = 384;   // warpgroup 0 loads, warpgroups 1-2 sum
constexpr int kAStage = kBM * kBK;              // 16 KB
constexpr int kRowsPerLoader = kBM * kBK / 16 / 128;   // 8 pieces a thread
constexpr int kSmemLimit = 232448;   // shared memory a block may take (H100)

enum Act {
  kLinear = 0, kLeaky = 1, kRelu = 2, kRelu6 = 3, kMish = 4, kSwish = 5,
  kLogistic = 6, kHSwish = 7, kHSigmoid = 8
};

__device__ __forceinline__ float sigmoidf(float y) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-y)));
}

// the activations other than leaky, linear and relu (those of yolov3 and
// most cfgs, which the epilogue applies inline)
__device__ __noinline__ float activate_rare(float y, int act) {
  switch (act) {
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

// ------------------------------------------------- barriers, copies, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// Spins until the phase of parity `parity` has completed. A wait that lasts
// seconds means a broken pipeline: trap (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  if (done) return;
  uint64_t t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 4000000000ull) __trap();     // 4 s
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// the barrier counts one arrival when this thread's earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar) : "memory");
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory operand descriptor of wgmma: K-major, 128-byte swizzle, rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO), base 1024-aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32 s32 += s8 x s8, A and B from shared memory
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int32_t (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int32_t (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int32_t (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int32_t (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

struct Params {
  const int8_t* x;
  const float* bias;
  void* out;
  int h, wd, cin, cout, k, stride, pad, ho, wo;
  int m_total, ktot, stages, tiles_n, tiles;
  int a_tma;   // 1x1 stride 1: A is the (m_total, cin) matrix x, by TMA
  int rows;    // int8 out, one channel tile, Cout % 16 != 0: see kernel
  float scale, oinv, slope;
  int act, qmin, qmax;
};

// The epilogue stages the s32 sums in slabs of 32 channels: kBM rows of
// kSlabPitch words (36: 16-byte aligned rows, and the fragments' 8-byte
// stores of 8 rows x 4 lanes fall in distinct banks).
constexpr int kSlab = 32;
constexpr int kSlabPitch = kSlab + 4;

// The block's shared memory: the ring of `stages` A (kBM x kBK) and B
// (BN x kBK) tiles, the epilogue's slab, the tile's output bytes where
// `rows` (see the kernel), the mbarriers, and room to align the ring to
// 1024 bytes.
__host__ __device__ constexpr int rows_bytes(int bn, bool rows) {
  return rows ? kBM * bn + 16 : 0;
}

__host__ __device__ constexpr int smem_bytes(int bn, int stages, bool rows) {
  return 1024 + stages * (kAStage + bn * kBK) + kBM * kSlabPitch * 4
         + rows_bytes(bn, rows) + 16 * stages;
}

// Dequantize, activate and requantize (or not) 16 channels co .. co + 15 of
// one output pixel from their s32 sums at shared address `src` (a slab row)
// and store the first `nc` of them at `dst`: one 16-byte store for int8
// (four for f32) where `vec` says dst is 16-byte aligned, else aligned words
// and bytes. Out of line: one copy of this code serves every slab.
template <bool kOutQ>
__device__ __noinline__ void store16(uint32_t src, const float* bias,
                                     void* dst, int co, int nc, bool vec,
                                     float scale, float oinv, int act,
                                     float slope, int lo, int hi) {
  int32_t a[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(a[4 * q]), "=r"(a[4 * q + 1]), "=r"(a[4 * q + 2]),
                   "=r"(a[4 * q + 3])
                 : "r"(src + 16 * q));
  }
  float y[16];
  if (nc == 16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + co) + q);
      y[4 * q] = b.x; y[4 * q + 1] = b.y; y[4 * q + 2] = b.z; y[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) y[i] = i < nc ? bias[co + i] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    y[i] = __fadd_rn(__fmul_rn(__int2float_rn(a[i]), scale), y[i]);
  }
  // one test of the activation for the 16 values
  if (act == kLeaky) {
    // y > 0 ? y : y * slope, as max(y, y * slope) for the 0 < slope < 1
    // that the wrapper passes (0.1, 0.25), signed zeros included
#pragma unroll
    for (int i = 0; i < 16; ++i) y[i] = fmaxf(y[i], __fmul_rn(y[i], slope));
  } else if (act == kRelu) {
#pragma unroll
    for (int i = 0; i < 16; ++i) y[i] = y[i] > 0.0f ? y[i] : 0.0f;
  } else if (act != kLinear) {
#pragma unroll
    for (int i = 0; i < 16; ++i) y[i] = activate_rare(y[i], act);
  }
  if constexpr (kOutQ) {
    // round half away from zero, copysign(floor(|v| + 0.5), v), as
    // trunc(v + copysign(0.5, v)): |v| + 0.5 rounds alike for either sign
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = __fmul_rn(y[4 * q + i], oinv);
        r[i] = min(max(__float2int_rz(__fadd_rn(v, copysignf(0.5f, v))), lo),
                   hi);
      }
      // the low bytes of r[0..3], in order
      w[q] = __byte_perm(__byte_perm(r[0], r[1], 0x0040),
                         __byte_perm(r[2], r[3], 0x0040), 0x5410);
    }
    int8_t* const d = static_cast<int8_t*>(dst);
    if (vec) {
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      // bytes up to a 4-byte boundary, then whole words, then bytes (word q
      // of the 16 bytes is selected, not indexed, so that w stays in
      // registers)
      const auto word = [&](int q) {
        return q == 0 ? w[0] : q == 1 ? w[1] : q == 2 ? w[2] : w[3];
      };
      int i = 0;
      for (; i < nc && (reinterpret_cast<uintptr_t>(d + i) & 3); ++i) {
        d[i] = static_cast<int8_t>(word(i >> 2) >> (8 * (i & 3)));
      }
      for (; i + 4 <= nc; i += 4) {
        *reinterpret_cast<uint32_t*>(d + i) =
            __funnelshift_r(word(i >> 2), word((i >> 2) + 1), 8 * (i & 3));
      }
      for (; i < nc; ++i) {
        d[i] = static_cast<int8_t>(word(i >> 2) >> (8 * (i & 3)));
      }
    }
  } else {
    float* const d = static_cast<float*>(dst);
    if (vec) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        reinterpret_cast<float4*>(d)[q] =
            make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
      }
    } else {
      for (int i = 0; i < nc; ++i) d[i] = y[i];
    }
  }
}

// barrier of the 128 threads of consumer warpgroup cw (ids 1 and 2; 0 is
// __syncthreads)
__device__ __forceinline__ void warpgroup_bar(int cw) {
  if (cw == 0) {
    asm volatile("bar.sync 1, 128;" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 128;" ::: "memory");
  }
}

// barrier of the 256 consumer threads
__device__ __forceinline__ void consumers_bar() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// A persistent block walks the tiles blockIdx.x, + gridDim.x, ...; tile t
// is pixels (t / tiles_n) * kBM .. + kBM and channels (t % tiles_n) * BN ..
// + BN (the channel tiles of one pixel tile run side by side and share its
// A tiles in L2). Its loader warpgroup runs ahead into the next tile while
// the consumers finish the epilogue of the last one.
template <int BN, bool kOutQ>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 2 : 1)
conv_int8_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, const Params p) {
  constexpr int kBStage = BN * kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  const int stages = p.stages;
  const uint32_t a_smem = base;
  const uint32_t b_smem = base + stages * kAStage;
  const int ring = stages * (kAStage + kBStage);
  int32_t* const slab = reinterpret_cast<int32_t*>(smem_raw + (base - raw)
                                                   + ring);
  int8_t* const rows = reinterpret_cast<int8_t*>(slab + kBM * kSlabPitch);
  const uint32_t bars = base + ring + kBM * kSlabPitch * 4
                        + rows_bytes(BN, p.rows);
  // full[s]: the stage's TMA bytes and the 128 loader threads' copies (when
  // A comes by cp.async) landed;
  // empty[s]: the 8 consumer warps finished the wgmma that read it
  const auto full = [&](int s) { return bars + 8u * s; };
  const auto empty = [&](int s) { return bars + 8u * (stages + s); };

  // the warpgroup index, warp-uniform as the compiler sees it (so that it
  // does not serialize the wgmma of a branch it cannot prove uniform)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
  const int t = threadIdx.x & 127;
  const int nk = (p.ktot + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), p.a_tma ? 1 : 128 + 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0 && p.a_tma) {
    // ---- loader of a 1x1 stride-1 conv: one thread, both tiles by TMA
    if (t != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM, co0 = (tile % p.tiles_n) * BN;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_arrive_expect_tx(full(s), kAStage + kBStage);
        tma_load_2d(a_smem + s * kAStage, &xmap, full(s), kc * kBK, m0);
        tma_load_2d(b_smem + s * kBStage, &wmap, full(s), kc * kBK, co0);
        if (++s == stages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }
  if (wg == 0) {
    // ---- loader: thread t copies 16-byte piece j of rows r0 + 16 i
    const int j = t & 7, r0 = t >> 3;
    const int hwo = p.ho * p.wo;
    // row r0 + 16 i keeps r0's swizzle phase (16 i is a multiple of 8)
    const uint32_t a_dst = a_smem + r0 * kBK + ((j ^ (r0 & 7)) << 4);
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM, co0 = (tile % p.tiles_n) * BN;
      long long pix[kRowsPerLoader];   // input pixel of the window origin
      int iy0[kRowsPerLoader], ix0[kRowsPerLoader];
#pragma unroll
      for (int i = 0; i < kRowsPerLoader; ++i) {
        const int m = m0 + r0 + 16 * i;
        if (m < p.m_total) {
          const int n = m / hwo, rem = m - n * hwo;
          const int oy = rem / p.wo, ox = rem - oy * p.wo;
          iy0[i] = oy * p.stride - p.pad;
          ix0[i] = ox * p.stride - p.pad;
          pix[i] = (static_cast<long long>(n) * p.h + iy0[i]) * p.wd + ix0[i];
        } else {                       // past the last pixel: always zero
          iy0[i] = -(1 << 29);
          ix0[i] = 0;
          pix[i] = 0;
        }
      }
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(empty(s), phase ^ 1);
        if (t == 0) {
          mbar_arrive_expect_tx(full(s), kBStage);
          tma_load_2d(b_smem + s * kBStage, &wmap, full(s), kc * kBK, co0);
        }
        const int f = kc * kBK + j * 16;   // flattened (ky, kx, c) of the piece
        if (f < p.ktot) {                  // past K*K*Cin: B is zero there
          const int tap = f / p.cin, c = f - tap * p.cin;
          const int ky = tap / p.k, kx = tap - ky * p.k;
          const long long off =
              (static_cast<long long>(ky) * p.wd + kx) * p.cin + c;
          const uint32_t dst = a_dst + s * kAStage;
#pragma unroll
          for (int i = 0; i < kRowsPerLoader; ++i) {
            const int iy = iy0[i] + ky, ix = ix0[i] + kx;
            const bool ok =
                static_cast<unsigned>(iy) < static_cast<unsigned>(p.h)
                && static_cast<unsigned>(ix) < static_cast<unsigned>(p.wd);
            cp_async16(dst + i * 16 * kBK,
                       ok ? p.x + pix[i] * p.cin + off : p.x, ok ? 16u : 0u);
          }
        }
        cp_async_arrive_noinc(full(s));
        if (++s == stages) { s = 0; phase ^= 1; }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // ---- consumers: warpgroup cw sums rows 64 cw .. 64 cw + 63 of each tile
  const int cw = wg - 1;
  const int warp = t >> 5, lane = t & 31;
  // the fragment layout: rows rl and rl + 8 of the warpgroup's 64, columns
  // cl and cl + 1 of each 8
  const int rl = warp * 16 + (lane >> 2);
  const int cl = (lane & 3) * 2;
  int32_t* const my_slab = slab + cw * 64 * kSlabPitch;
  // the epilogue's share: 16 channels of row er of each slab
  const int er = t >> 1, ec = (t & 1) * 16;
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.tiles_n) * kBM, co0 = (tile % p.tiles_n) * BN;
    int32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full(s), phase);
      // the loaders' cp.async writes (generic proxy) before wgmma's reads
      if (!p.a_tma) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      const int left = p.ktot - kc * kBK;   // > 0; k32 steps past it are zero
      const uint64_t da = smem_desc(a_smem + s * kAStage + cw * 64 * kBK);
      const uint64_t db = smem_desc(b_smem + s * kBStage);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      Wgmma<BN>::mma(acc, da, db);          // +32 bytes = +2 in the address
      if (left > 32) Wgmma<BN>::mma(acc, da + 2, db + 2);
      if (left > 64) Wgmma<BN>::mma(acc, da + 4, db + 4);
      if (left > 96) Wgmma<BN>::mma(acc, da + 6, db + 6);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      // the previous stage's wgmma has completed: hand it back
      if (kc > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
      if (++s == stages) { s = 0; phase ^= 1; }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty(prev));

    // ---- epilogue, a slab of 32 channels at a time: fragments -> this
    // warpgroup's 64 slab rows -> each thread's 16 channels of one row.
    // Where `rows` (int8 out, Cout not a multiple of 16, one channel tile)
    // the tile's output is one run of bytes, out[m0 * cout ..]: it is built
    // in `rows` at the run's 16-byte phase and copied out with 16-byte
    // stores, where stores straight from the slab would split every row.
    const int m = m0 + cw * 64 + er;
    int8_t* const run = static_cast<int8_t*>(p.out)
                        + static_cast<long long>(m0) * p.cout;
    const int run_phase =
        static_cast<int>(reinterpret_cast<uintptr_t>(run) & 15);
#pragma unroll
    for (int sl = 0; sl < BN / kSlab; ++sl) {
      warpgroup_bar(cw);            // the slab's last readers are done
#pragma unroll
      for (int jj = 0; jj < kSlab / 8; ++jj) {
        const int jn = sl * (kSlab / 8) + jj;
        int32_t* const d = my_slab + rl * kSlabPitch + jj * 8 + cl;
        *reinterpret_cast<int2*>(d) = make_int2(acc[4 * jn], acc[4 * jn + 1]);
        *reinterpret_cast<int2*>(d + 8 * kSlabPitch) =
            make_int2(acc[4 * jn + 2], acc[4 * jn + 3]);
      }
      warpgroup_bar(cw);
      const int co = co0 + sl * kSlab + ec;
      if (m < p.m_total && co < p.cout) {
        const int nc = p.cout - co < 16 ? p.cout - co : 16;
        const long long at = static_cast<long long>(m) * p.cout + co;
        void* const dst =
            p.rows ? static_cast<void*>(rows + run_phase
                                        + (at - static_cast<long long>(m0) * p.cout))
            : kOutQ ? static_cast<void*>(static_cast<int8_t*>(p.out) + at)
                    : static_cast<void*>(static_cast<float*>(p.out) + at);
        const bool vec = !p.rows && nc == 16 && p.cout % (kOutQ ? 16 : 4) == 0;
        store16<kOutQ>(smem_u32(my_slab + er * kSlabPitch + ec), p.bias, dst,
                       co, nc, vec, p.scale, p.oinv, p.act, p.slope, p.qmin,
                       p.qmax);
      }
    }
    if (p.rows) {
      consumers_bar();              // both warpgroups' rows are in `rows`
      const int ct = cw * 128 + t;
      const int pixels = p.m_total - m0 < kBM ? p.m_total - m0 : kBM;
      const int n = pixels * p.cout;
      const int lead = (16 - run_phase) & 15;   // bytes to a 16-byte boundary
      const int head = lead < n ? lead : n;
      if (ct < head) run[ct] = rows[run_phase + ct];
      const int vecs = (n - head) >> 4;
      for (int v = ct; v < vecs; v += 256) {
        *reinterpret_cast<uint4*>(run + head + 16 * v) =
            *reinterpret_cast<const uint4*>(rows + run_phase + head + 16 * v);
      }
      const int tail = head + 16 * vecs + ct;
      if (tail < n) run[tail] = rows[run_phase + tail];
      consumers_bar();              // copied out before the next tile's rows
    }
  }
}

// -------------------------------------------------------------------- host

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the CUDA driver's tensor-map encoder, through the runtime (no -lcuda link),
// looked up once
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f) : nullptr;
  }();
  return fn;
}

// host-side refusals, below every cudaError_t
constexpr int kErrPlan = -1;
constexpr int kErrEntry = -2;
constexpr int kErrMap = -3;

constexpr int kMaxDevices = 64;

// The persistent grid of one configuration on one device: the blocks that
// fit all its SMs at once. The first launch of a configuration on a device
// allows the kernel the most dynamic shared memory a block may take (an
// attribute of the function, shared by all its configurations, so it is
// never lowered) and asks the occupancy; later launches read the cache (the
// host's time per call is part of every caller's wait). Returns 0 where the
// configuration cannot launch.
template <int BN, bool kOutQ>
int resident_blocks(int dev, int stages, bool rows) {
  static std::atomic<int> cached[kMaxDevices][2][9];   // zero at start
  std::atomic<int>* const slot =
      dev < kMaxDevices ? &cached[dev][rows ? 1 : 0][stages] : nullptr;
  if (slot != nullptr) {
    const int n = slot->load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  const int smem = smem_bytes(BN, stages, rows);
  int per_sm = 0, sms = 0;
  if (cudaFuncSetAttribute(conv_int8_kernel<BN, kOutQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemLimit) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, conv_int8_kernel<BN, kOutQ>, kThreads, smem)
             != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess) {
    return 0;
  }
  if (slot != nullptr) slot->store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

template <int BN, bool kOutQ>
int launch(int dev, const CUtensorMap& wmap, const CUtensorMap& xmap,
           const Params& p, cudaStream_t s) {
  const int resident = resident_blocks<BN, kOutQ>(dev, p.stages, p.rows != 0);
  if (resident == 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  // persistent: as many blocks as fit at once, none idle
  const int grid = p.tiles < resident ? p.tiles : resident;
  conv_int8_kernel<BN, kOutQ><<<grid, kThreads,
                                smem_bytes(BN, p.stages, p.rows != 0), s>>>(
      wmap, xmap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: int8 (n, h, wd, cin) with cin % 16 == 0; w: int8 (cout, k, k, cin);
// bias: f32 (cout,); out: (n, ho, wo, cout) int8 (out_q) or f32. All
// contiguous on CUDA device `device`, x, w and bias 16-byte aligned. bn (32,
// 64, 128 or 256), stages (2-8) and rows are the tile plan of
// ops/conv_int8.py: rows (int8 out, one channel tile) builds each tile's
// output as one run of bytes in kBM * bn + 16 more bytes of shared memory.
// Launches on `stream` (a stream of `device`) and returns cudaGetLastError()
// (0 on success), or a negative code for a refusal before the launch.
int conv_int8_launch(const void* x, const void* w, const void* bias, void* out,
                     int n, int h, int wd, int cin, int cout, int k,
                     int stride, int pad, int ho, int wo, float scale,
                     float oinv, int act, float slope, int out_q, int qmin,
                     int qmax, int bn, int stages, int rows, int device,
                     void* stream) {
  const long long m_total = static_cast<long long>(n) * ho * wo;
  if (m_total == 0 || cout == 0) return 0;
  const long long ktot = static_cast<long long>(k) * k * cin;
  const bool bn_ok = bn == 32 || bn == 64 || bn == 128 || bn == 256;
  if (!bn_ok || cin % 16 != 0 || stages < 2 || stages > 8
      || (rows && (!out_q || cout > bn))
      || m_total > 0x7fffffffLL - kBM || ktot > 0x7fffffffLL - kBK
      || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || reinterpret_cast<uintptr_t>(w) % 16 != 0
      || reinterpret_cast<uintptr_t>(bias) % 16 != 0
      || smem_bytes(bn, stages, rows) > kSmemLimit) {
    return kErrPlan;
  }
  const long long tiles_n = (cout + bn - 1) / bn;
  const long long tiles = (m_total + kBM - 1) / kBM * tiles_n;
  if (tiles > 0x7fffffffLL) return kErrPlan;

  // B: the weights as a (cout, k*k*cin) byte matrix, one 128-byte x bn box
  // a stage; A of a 1x1 stride-1 conv: x as an (m_total, cin) byte matrix,
  // one 128-byte x 128-row box. Both 128-byte swizzled, zero past the ends.
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrEntry;
  const auto encode2d = [&](CUtensorMap* map, const void* ptr,
                            long long inner, long long rows, int box_rows) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem_strides[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                  dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  const bool a_tma = k == 1 && stride == 1;
  alignas(64) CUtensorMap wmap;
  alignas(64) CUtensorMap xmap;
  if (!encode2d(&wmap, w, ktot, cout, bn)
      || (a_tma && !encode2d(&xmap, x, cin, m_total, kBM))) {
    return kErrMap;
  }
  if (!a_tma) xmap = wmap;   // not read

  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.h = h; p.wd = wd; p.cin = cin; p.cout = cout; p.k = k;
  p.stride = stride; p.pad = pad; p.ho = ho; p.wo = wo;
  p.m_total = static_cast<int>(m_total);
  p.ktot = static_cast<int>(ktot);
  p.stages = stages;
  p.tiles_n = static_cast<int>(tiles_n);
  p.tiles = static_cast<int>(tiles);
  p.a_tma = a_tma ? 1 : 0;
  p.rows = rows ? 1 : 0;
  p.scale = scale; p.oinv = oinv; p.slope = slope;
  p.act = act; p.qmin = qmin; p.qmax = qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // launch on `device`, and leave the caller's current device as it was
  int cur = 0;
  if (cudaGetDevice(&cur) != cudaSuccess
      || (cur != device && cudaSetDevice(device) != cudaSuccess)) {
    return static_cast<int>(cudaGetLastError());
  }
  int err;
  switch (bn * 2 + (out_q ? 1 : 0)) {
    case 64: err = launch<32, false>(device, wmap, xmap, p, s); break;
    case 65: err = launch<32, true>(device, wmap, xmap, p, s); break;
    case 128: err = launch<64, false>(device, wmap, xmap, p, s); break;
    case 129: err = launch<64, true>(device, wmap, xmap, p, s); break;
    case 256: err = launch<128, false>(device, wmap, xmap, p, s); break;
    case 257: err = launch<128, true>(device, wmap, xmap, p, s); break;
    case 512: err = launch<256, false>(device, wmap, xmap, p, s); break;
    default: err = launch<256, true>(device, wmap, xmap, p, s); break;
  }
  if (cur != device) cudaSetDevice(cur);
  return err;
}

const char* conv_int8_error_string(int err) {
  switch (err) {
    case kErrPlan: return "the tile plan or the inputs are outside what the "
                          "kernel takes (Cin % 16, 16-byte alignment, bn, "
                          "stages, rows, shared memory, sizes)";
    case kErrEntry: return "cuTensorMapEncodeTiled not found in the CUDA driver";
    case kErrMap: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
