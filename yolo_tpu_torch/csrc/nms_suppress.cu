// Greedy-NMS suppression + merge-NMS box fusion, one thread block per image.
//
// Replaces yolo_tpu/ops/pallas_nms.py::_suppress_kernel (the Pallas TPU
// kernel behind yolo_tpu/ops/nms.py::_suppress_and_finalize). Same contract:
//   keep[j]   = fixpoint of valid[j] & !any_{i<j}(iou(i,j) > thres & keep[i]),
//               at most max_sweeps sweeps (the fixpoint is reached earlier
//               whenever suppression chains are shorter than the cap, and a
//               sweep past the fixpoint changes nothing, so stopping there
//               gives the result of exactly max_sweeps sweeps);
//   merged[i] = sum_j w_ij box_j / sum_j w_ij with w_ij = (iou(i,j) > thres)
//               * score_j * valid_j, or box_i where sum_j w_ij == 0.
// The plain PyTorch twin is yolo_tpu_torch/ops/nms_suppress.py::
// suppress_reference.
//
// What bounds it on an H100: per image k*(k-1)/2 IoUs (an IEEE division
// each) to build the graph, up to max_sweeps sweeps of k*k/32 word ANDs, and
// k*k bit tests for the merge, with k <= 1024. That is about a million
// simple operations per image: latency bound, and with one block per image a
// batch of bs images fills only bs of the 132 SMs.
// What the design does about it: the class-offset boxes and the whole
// suppression graph live in shared memory (the graph as one bitmask word per
// 32 rows of each column: k*ceil(k/32)*4 bytes, 32 KB at k=512, 128 KB at
// k=1024), so the sweeps never touch device memory. Each sweep is one pass of
// word ANDs per column, and each warp rebuilds its keep word with
// __ballot_sync; the loop stops at the fixpoint. Each pair's IoU is computed
// once: IoU is symmetric (the two areas are added in either order to the
// same float), so the merge reads iou(i, j) > thres for j < i from column i
// and for j > i from row i of the columns j > i.
//
// Numerics: the IoU is evaluated as inter / (area_i + area_j - inter + EPS)
// in that order, as in the plain version, and the build passes --fmad=false,
// so no multiply-add is contracted and the keep bits equal the plain
// version's bit for bit, also where iou == thres.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-16f;
constexpr int kMaxK = 1024;

__device__ __forceinline__ float box_iou(const float* a, const float* b) {
  const float iw = fmaxf(fminf(a[2], b[2]) - fmaxf(a[0], b[0]), 0.0f);
  const float ih = fmaxf(fminf(a[3], b[3]) - fmaxf(a[1], b[1]), 0.0f);
  const float inter = iw * ih;
  const float area_a = (a[2] - a[0]) * (a[3] - a[1]);
  const float area_b = (b[2] - b[0]) * (b[3] - b[1]);
  return inter / (area_a + area_b - inter + kEps);
}

// blockDim.x == 32 * ceil(k / 32): thread j owns column j of the graph.
__global__ void __launch_bounds__(kMaxK)
nms_suppress_kernel(const float* __restrict__ oboxes,
                    const float* __restrict__ boxes,
                    const float* __restrict__ scores,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep_out,
                    float* __restrict__ merged_out,
                    int k, float iou_thres, int max_sweeps, int merge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (k + 31) / 32;
  float* s_ob = reinterpret_cast<float*>(smem);              // (k, 4)
  float* s_box = s_ob + 4 * k;                               // (k, 4)
  float* s_w = s_box + 4 * k;                                // (k,) score*valid
  uint32_t* s_col = reinterpret_cast<uint32_t*>(s_w + k);    // (nw, k)
  uint32_t* s_keep = s_col + k * nw;                         // (nw,)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t img = blockIdx.x;
  const float* ob = oboxes + img * k * 4;
  const float* bx = boxes + img * k * 4;
  const uint8_t* vd = valid + img * k;

  for (int t = tid; t < 4 * k; t += blockDim.x) {
    s_ob[t] = ob[t];
    s_box[t] = bx[t];
  }
  for (int t = tid; t < k; t += blockDim.x) {
    s_w[t] = vd[t] ? scores[img * k + t] : 0.0f;
  }
  __syncthreads();

  // Suppression graph: bit (i - 32w) of word s_col[w*k + j] is set when
  // i < j and iou(i, j) > thres (earlier, higher-scored boxes suppress
  // later ones). Word-major, so a warp's 32 columns share w: their loops
  // have nearly equal lengths and their accesses hit distinct banks.
  for (int idx = tid; idx < k * nw; idx += blockDim.x) {
    const int w = idx / k;
    const int j = idx - w * k;
    const int i0 = 32 * w;
    const int i1 = min(i0 + 32, j);
    uint32_t bits = 0u;
    for (int i = i0; i < i1; ++i) {
      if (box_iou(s_ob + 4 * i, s_ob + 4 * j) > iou_thres) {
        bits |= 1u << (i - i0);
      }
    }
    s_col[idx] = bits;
  }

  const int j = tid;
  const bool vj = j < k && vd[j] != 0;
  bool kj = vj;
  unsigned ball = __ballot_sync(0xffffffffu, kj);
  if (lane == 0) s_keep[tid >> 5] = ball;
  __syncthreads();

  for (int s = 0; s < max_sweeps; ++s) {
    bool suppressed = false;
    if (vj) {
      const int nwj = (j >> 5) + 1;      // words past row j are all zero
      for (int w = 0; w < nwj; ++w) {
        if (s_col[w * k + j] & s_keep[w]) {
          suppressed = true;
          break;
        }
      }
    }
    const bool nk = vj && !suppressed;
    ball = __ballot_sync(0xffffffffu, nk);
    const int changed = nk != kj;
    __syncthreads();                     // every thread has read s_keep
    if (lane == 0) s_keep[tid >> 5] = ball;
    kj = nk;
    if (!__syncthreads_or(changed)) break;
  }
  if (j < k) keep_out[img * k + j] = kj ? 1 : 0;

  if (j < k) {
    const float* bi = s_box + 4 * j;
    float m0 = bi[0], m1 = bi[1], m2 = bi[2], m3 = bi[3];
    if (merge) {
      // weighted mean over every q with iou(j, q) > thres, q ascending
      float den = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      auto add = [&](int q) {
        const float wq = s_w[q];
        if (wq == 0.0f) return;                      // invalid candidate
        const float* bq = s_box + 4 * q;
        den += wq;
        a0 += wq * bq[0];
        a1 += wq * bq[1];
        a2 += wq * bq[2];
        a3 += wq * bq[3];
      };
      for (int w = 0; w <= (j >> 5); ++w) {          // q < j: column j
        for (uint32_t bits = s_col[w * k + j]; bits; bits &= bits - 1) {
          add(32 * w + __ffs(bits) - 1);
        }
      }
      const float* oj = s_ob + 4 * j;
      if (box_iou(oj, oj) > iou_thres) add(j);       // q == j
      const uint32_t* row = s_col + (j >> 5) * k;    // q > j: bit j of col q
      const uint32_t bit = 1u << (j & 31);
      for (int q = j + 1; q < k; ++q) {
        if (row[q] & bit) add(q);
      }
      if (den > 0.0f) {
        const float d = fmaxf(den, 1e-12f);
        m0 = a0 / d;
        m1 = a1 / d;
        m2 = a2 / d;
        m3 = a3 / d;
      }
    }
    float* mo = merged_out + (img * k + j) * 4;
    mo[0] = m0;
    mo[1] = m1;
    mo[2] = m2;
    mo[3] = m3;
  }
}

}  // namespace

extern "C" int nms_suppress_launch(const float* oboxes, const float* boxes,
                                   const float* scores, const uint8_t* valid,
                                   uint8_t* keep, float* merged, int bs, int k,
                                   float iou_thres, int max_sweeps, int merge,
                                   void* stream) {
  if (bs < 1 || k < 1 || k > kMaxK || max_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nw = (k + 31) / 32;
  const size_t smem = sizeof(float) * 9 * static_cast<size_t>(k) +
                      sizeof(uint32_t) * (static_cast<size_t>(k) * nw + nw);
  cudaError_t err = cudaFuncSetAttribute(
      nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_suppress_kernel<<<bs, 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
      oboxes, boxes, scores, valid, keep, merged, k, iou_thres, max_sweeps,
      merge);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nms_suppress_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
