// Greedy-NMS suppression + merge-NMS box fusion, one thread-block cluster
// per image.
//
// Replaces yolo_tpu/ops/pallas_nms.py::_suppress_kernel (the Pallas TPU
// kernel behind yolo_tpu/ops/nms.py::_suppress_and_finalize). Same contract:
//   keep[j]   = valid[j] & !any_{i<j}(iou(i,j) > thres & keep[i]), run as
//               Jacobi sweeps from keep = valid, at most max_sweeps of them
//               (a sweep past the fixpoint changes nothing, so stopping
//               there gives the result of exactly max_sweeps sweeps; a chain
//               longer than the cap is left unconverged, as in the plain
//               version);
//   merged[i] = sum_j w_ij box_j / sum_j w_ij with w_ij = (iou(i,j) > thres)
//               * score_j * valid_j, or box_i where sum_j w_ij == 0.
// The plain PyTorch twin is yolo_tpu_torch/ops/nms_suppress.py::
// suppress_reference; the cluster size comes from its suppress_plan.
//
// What bounds it on an H100: per image k*k IoU tests, up to max_sweeps
// sweeps of k*k/32 word ANDs, and a merge over the overlapping pairs, with
// k <= 1024: a few million simple operations per image, far below a
// microsecond of the card's rate. The time is latency: chains of
// dependent steps, on few SMs and with few warps to hide them.
// What the design does about it: an image is a cluster of C CTAs of 512
// threads (suppress_plan: C = min(C_max, ceil(k / 32)), C_max 16 where
// the card holds bs clusters of 16 at once, else 8), so bs=8 images run on
// 64-128 SMs. CTA r owns a contiguous run of column words (32 candidates
// each) and builds the full symmetric graph of its columns in its shared
// memory: a warp takes a block of 32 columns (a lane each, the column's box
// in registers) by 32 rows, reads each row's box once for all its lanes
// and packs each lane's word with shifts; every thread does the same
// k*k/(C*512) tests, and all but the pairs within ~2^-18 of the threshold
// skip the division (graph_word). The sweeps read the column words masked
// to i < j; the merge reads the whole column (every q with
// iou(j, q) > thres, q == j included), a few lanes per column walking only
// its set bits, with no exchange between CTAs. The keep vector (k bits)
// lives in every warp's registers, lane t holding word t. In a sweep each
// CTA computes the new words of its own columns (one ballot per 32
// columns), stores them into the next keep buffer of every CTA of the
// cluster through distributed shared memory (DSMEM), and passes one
// cluster barrier. Every CTA then holds the same whole vector and takes
// the same decision to stop at the fixpoint, with no further reduction.
//
// Where it can go wrong, and what the code does about it:
// - DSMEM ordering. No CTA stores into a peer before every CTA of the
//   cluster has started: the cluster barrier after the build comes before
//   the first sweep. After the barrier of sweep s a CTA takes the new
//   vector into registers and compares it with the previous vector, which
//   it holds in registers too: it never reads the old buffer again, because
//   a faster peer may already be writing it in sweep s+1. No CTA exits
//   while a peer may still store into it: every thread arrives at one last
//   cluster barrier after the sweeps and waits on it before the exit (the
//   merge runs in between). A slip here gives a rare wrong keep under long
//   chains, or CTAs that disagree on the exit and deadlock: the chain tests
//   (tests/test_torch_slice.py, chip_smoke.py phase 3) cap the sweeps
//   below the chain's length to catch it.
// - Cluster scheduling. Clusters of 16 are not portable: the plan takes 16
//   only where cudaOccupancyMaxActiveClusters (nms_suppress_max_clusters)
//   says the card holds bs of them at once. A refused launch returns its
//   cudaError; there is no retry with another cluster size.
// - Ragged k. The last CTA's run may hold columns past k, built from zero
//   boxes and never read; rows past k are zero boxes whose bits are
//   cleared. Their keep bits are 0, every lane still votes in every
//   ballot, and every thread passes every cluster barrier.
//
// Numerics: the IoU's terms are evaluated as in the plain version,
// inter / (area_i + area_j - inter + EPS) in that order, and the build
// passes --fmad=false, so no multiply-add is contracted. The test against
// thres skips the division only where its outcome is certain (graph_word),
// so the keep bits equal the plain version's bit for bit, also where
// iou == thres. The merge reads iou(q, j) for iou(j, q): fminf/fmaxf are
// symmetric and the two areas add to the same float in either order. Its
// sums run in another order than the plain version's, so merged agrees
// within rounding, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-16f;
constexpr int kMaxK = 1024;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

// words of a keep vector or of a graph column: one bit per candidate
__host__ __device__ constexpr int words(int k) {
  return (k + 31) / 32;
}

// the most column words a CTA owns when an image is `cluster` CTAs: CTA r
// owns words r * nw / cluster .. (r + 1) * nw / cluster - 1
__host__ __device__ constexpr int run_words(int k, int cluster) {
  return (words(k) + cluster - 1) / cluster;
}

// A CTA's shared memory: the class-offset boxes and their areas (20 bytes
// each, padded with zeros to whole words), the raw boxes and score * valid
// (20 bytes each), the graph of its columns (a word per 32 rows of each of
// 32 * run_words columns) and the two keep buffers.
__host__ __device__ constexpr int smem_bytes(int k, int cluster) {
  return 640 * words(k) + 20 * k + 128 * words(k) * run_words(k, cluster)
         + 8 * words(k);
}

// iou(i, j) > thres without the division. The plain version compares
// q = RN(inter / den) with thres, den = area_i + area_j - inter + EPS.
// With p = RN(thres * den), all of thres, den and p normal (thres and den
// within [2^-60, 2^60]): inter >= RN(p * (1 + 2^-18)) gives
// inter / den > thres * (1 + 2^-19), above the float after thres, so
// q > thres; inter <= RN(p * (1 - 2^-18)) gives inter / den < thres *
// (1 - 2^-19), so q <= thres (each rounding is within 2^-24 of its
// value). Only a pair between the two bounds, within ~2^-18 of the
// threshold, takes the IEEE division. den is within range wherever every
// box of the image is well formed (x2 >= x1, y2 >= y1) with an area of at
// most 2^58: rounding is monotonic, so inter <= min(area_i, area_j) and
// EPS <= den <= 2^59. The kernel checks that once per image
// (`fast`); any other image takes the division for every pair.
constexpr float kUp = 1.0f + 0x1p-18f;
constexpr float kDown = 1.0f - 0x1p-18f;
constexpr float kTiny = 0x1p-60f;
constexpr float kHuge = 0x1p60f;
constexpr float kMaxArea = 0x1p58f;

__device__ __forceinline__ float box_area(float4 a) {
  return (a.z - a.x) * (a.w - a.y);
}

// inter and den of the pair (row box a, column box b), as the plain
// version evaluates them
__device__ __forceinline__ void pair_terms(float4 a, float area_a, float4 b,
                                           float area_b, float& inter,
                                           float& den) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  inter = iw * ih;
  den = area_a + area_b - inter + kEps;
}

// One word of the graph: bit r is iou(32t + r, j) > thres for this lane's
// column j (box bj, area aj), rows past k cleared. The row boxes are read
// once for the whole warp (the same address in every lane).
template <bool kFast>
__device__ __forceinline__ uint32_t graph_word(const float4* s_ob,
                                               const float* s_area, int t,
                                               float4 bj, float aj,
                                               float thres, int k) {
  uint32_t bits = 0u, unsure = 0u;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    float inter, den;
    pair_terms(s_ob[32 * t + r], s_area[32 * t + r], bj, aj, inter, den);
    bool over;
    if (kFast) {
      const float p = thres * den;
      over = inter >= p * kUp;
      if (!over && !(inter <= p * kDown)) unsure |= 1u << r;
    } else {
      over = inter / den > thres;
    }
    bits |= static_cast<uint32_t>(over) << r;
  }
  for (; unsure; unsure &= unsure - 1) {       // within 2^-18 of thres
    const int r = __ffs(unsure) - 1;
    float inter, den;
    pair_terms(s_ob[32 * t + r], s_area[32 * t + r], bj, aj, inter, den);
    if (inter / den > thres) bits |= 1u << r;
  }
  const int rows = k - 32 * t;
  return rows >= 32 ? bits : bits & ((1u << rows) - 1u);
}

__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float4* __restrict__ oboxes,
                    const float4* __restrict__ boxes,
                    const float* __restrict__ scores,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep_out,
                    float4* __restrict__ merged_out,
                    int k, float iou_thres, int max_sweeps, int merge) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t img = blockIdx.x / csize;
  const int nw = words(k);
  const int w0 = rank * nw / csize;            // own column words w0 .. w1-1
  const int w1 = (rank + 1) * nw / csize;
  const int pitch = 32 * run_words(k, csize);  // graph row: one word a column
  const int cols = 32 * (w1 - w0);
  const int live = min(cols, k - 32 * w0);     // own columns below k

  extern __shared__ __align__(16) unsigned char smem[];
  float4* const s_ob = reinterpret_cast<float4*>(smem);         // (32 nw,)
  float4* const s_box = s_ob + 32 * nw;                          // (k,)
  float* const s_area = reinterpret_cast<float*>(s_box + k);    // (32 nw,)
  float* const s_w = s_area + 32 * nw;                           // (k,)
  uint32_t* const s_col = reinterpret_cast<uint32_t*>(s_w + k);  // (nw, pitch)
  uint32_t* const s_keep = s_col + nw * pitch;                   // (2, nw)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint8_t* const vd = valid + img * k;

  bool well = true;                            // boxes the fast test takes
  for (int t = tid; t < 32 * nw; t += kThreads) {   // whole words: uniform
    bool v = false;
    float4 ob = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // rows past k: zeros
    if (t < k) {
      v = vd[t] != 0;
      ob = oboxes[img * k + t];
      s_box[t] = boxes[img * k + t];
      s_w[t] = v ? scores[img * k + t] : 0.0f;
    }
    const float area = box_area(ob);
    well = well && ob.z >= ob.x && ob.w >= ob.y && area <= kMaxArea;
    s_ob[t] = ob;
    s_area[t] = area;
    const unsigned word = __ballot_sync(kFull, v);
    if (lane == 0) s_keep[t >> 5] = word;        // keep = valid before sweep 0
  }
  const bool fast = __syncthreads_and(well) && iou_thres >= kTiny
                    && iou_thres <= kHuge;

  // The graph of the own columns: bit (i - 32t) of s_col[t * pitch + c] is
  // iou(i, j) > thres for column j = 32 * w0 + c, every row i < k. A warp
  // takes one block of 32 columns (a lane each, its box in registers) by
  // 32 rows at a time (graph_word). Columns past k are built from zero
  // boxes and never read: their keep bits are 0 and the merge stops at k.
  for (int b = warp; b < (w1 - w0) * nw; b += kWarps) {
    const int cw = b / nw;
    const int t = b - cw * nw;
    const int c = 32 * cw + lane;
    const float4 bj = s_ob[32 * w0 + c];
    const float aj = s_area[32 * w0 + c];
    s_col[t * pitch + c] =
        fast ? graph_word<true>(s_ob, s_area, t, bj, aj, iou_thres, k)
             : graph_word<false>(s_ob, s_area, t, bj, aj, iou_thres, k);
  }

  // every CTA of the cluster has started (no store into a peer before it),
  // and the graph and the first keep words are visible to the whole CTA
  cluster.sync();

  uint32_t keepw = lane < nw ? s_keep[lane] : 0u;   // lane t: word t
  const uint32_t validw = keepw;
  const int cw = w0 + warp;                    // the column word this warp
  const bool sweeper = cw < w1;                // sweeps, if it owns one
  const int jl = 32 * warp + lane;
  int buf = 0;
  for (int s = 0; s < max_sweeps; ++s) {
    const int nxt = buf ^ 1;
    if (sweeper) {                             // uniform over the warp
      const uint32_t* col = s_col + jl;
      uint32_t hit = 0u;
      for (int t = 0; t < cw; ++t) {           // rows i < 32 * cw
        hit |= col[t * pitch] & __shfl_sync(kFull, keepw, t);
      }
      hit |= col[cw * pitch] & __shfl_sync(kFull, keepw, cw)
             & ((1u << lane) - 1u);            // rows 32 * cw <= i < j
      const bool vj = (__shfl_sync(kFull, validw, cw) >> lane) & 1u;
      const uint32_t word = __ballot_sync(kFull, vj && hit == 0u);
      if (lane < csize) {
        *cluster.map_shared_rank(s_keep + nxt * nw + cw, lane) = word;
      }
    }
    cluster.sync();
    // the new vector into registers; the old buffer is not read again
    const uint32_t neww = lane < nw ? s_keep[nxt * nw + lane] : 0u;
    const bool changed = __any_sync(kFull, neww != keepw);
    keepw = neww;
    buf = nxt;
    if (!changed) break;                       // the same on every CTA
  }
  // no store into a peer after this point: arrive at the exit barrier now,
  // wait on it before the exit. The arrival orders no memory (relaxed):
  // the last stores into peers were ordered by the last sweep's barrier.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const uint32_t own = __shfl_sync(kFull, keepw, sweeper ? cw : 0);
  if (sweeper && 32 * cw + lane < k) {
    keep_out[img * k + 32 * cw + lane] = (own >> lane) & 1u;
  }

  // The merge of the own columns below k. Each column gets `share`
  // consecutive lanes (the largest power of two with share * cols <=
  // kThreads); lane p of them walks the set bits of the column's words p,
  // p + share, ... (every q with iou(q, j) > thres), so the work follows
  // the overlaps, not k * k; then the share's lanes add their sums.
  int share = 1;
  while (2 * share * cols <= kThreads) share *= 2;
  const int c = tid / share;                   // share <= 16: one warp
  const int part = tid - c * share;
  float den = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (merge && c < live) {
    for (int t = part; t < nw; t += share) {
      for (uint32_t bits = s_col[t * pitch + c]; bits; bits &= bits - 1) {
        const int q = 32 * t + __ffs(bits) - 1;
        const float wq = s_w[q];               // 0 for an invalid q
        const float4 b = s_box[q];
        den += wq;
        a0 += wq * b.x;
        a1 += wq * b.y;
        a2 += wq * b.z;
        a3 += wq * b.w;
      }
    }
  }
  for (int o = share / 2; o > 0; o >>= 1) {    // uniform: share is
    den += __shfl_xor_sync(kFull, den, o);     // the same in every lane
    a0 += __shfl_xor_sync(kFull, a0, o);
    a1 += __shfl_xor_sync(kFull, a1, o);
    a2 += __shfl_xor_sync(kFull, a2, o);
    a3 += __shfl_xor_sync(kFull, a3, o);
  }
  if (part == 0 && c < live) {
    const int j = 32 * w0 + c;
    float4 m = s_box[j];
    if (merge && den > 0.0f) {
      const float d = fmaxf(den, 1e-12f);
      m = make_float4(a0 / d, a1 / d, a2 / d, a3 / d);
    }
    merged_out[img * k + j] = m;
  }

  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// host-side refusals, below every cudaError_t
constexpr int kErrPlan = -1;

constexpr int kMaxDevices = 64;

// Once per device: the kernel may take up to kSmemLimit bytes of dynamic
// shared memory and clusters of 16 (attributes of the function; the host's
// time per call is part of every caller's wait).
cudaError_t prepare(int dev) {
  static std::atomic<int> ready[kMaxDevices];       // zero at start
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && ready[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(nms_suppress_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess && cached) ready[dev].store(1, std::memory_order_relaxed);
  return e;
}

// Switches to `device` for the call, and back to the caller's device after.
class OnDevice {
 public:
  explicit OnDevice(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~OnDevice() {
    if (err_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int device_;
  int prev_ = 0;
  cudaError_t err_;
};

// What the kernel takes: a sweep gives each warp one column word, so a CTA
// owns at most kWarps words (cluster >= k / 512).
bool plan_ok(int bs, int k, int cluster) {
  return bs >= 1 && k >= 1 && k <= kMaxK && cluster >= 1
         && cluster <= kMaxCluster && cluster <= words(k)
         && run_words(k, cluster) <= kWarps
         && static_cast<long long>(bs) * cluster <= 0x7fffffffLL
         && smem_bytes(k, cluster) <= kSmemLimit;
}

// bs images of `cluster` CTAs each, in clusters of `cluster`
cudaLaunchConfig_t launch_config(int bs, int k, int cluster, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bs * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(k, cluster);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// oboxes, boxes: f32 (bs, k, 4), 16-byte aligned; scores: f32 (bs, k);
// valid: bool (bs, k); keep: bool (bs, k); merged: f32 (bs, k, 4), 16-byte
// aligned. All contiguous on CUDA device `device`. `cluster` CTAs per image
// (ops/nms_suppress.py::suppress_plan). Launches on `stream` (a stream of
// `device`) and returns cudaGetLastError() (0 on success), or a negative
// code for a refusal before the launch.
int nms_suppress_launch(const void* oboxes, const void* boxes,
                        const float* scores, const uint8_t* valid,
                        uint8_t* keep, void* merged, int bs, int k,
                        float iou_thres, int max_sweeps, int merge,
                        int cluster, int device, void* stream) {
  if (!plan_ok(bs, k, cluster) || max_sweeps < 0
      || reinterpret_cast<uintptr_t>(oboxes) % 16 != 0
      || reinterpret_cast<uintptr_t>(boxes) % 16 != 0
      || reinterpret_cast<uintptr_t>(merged) % 16 != 0) {
    return kErrPlan;
  }
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaError_t e = prepare(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      bs, k, cluster, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, nms_suppress_kernel,
                         static_cast<const float4*>(oboxes),
                         static_cast<const float4*>(boxes), scores, valid,
                         keep, static_cast<float4*>(merged), k, iou_thres,
                         max_sweeps, merge);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` CTAs at this k the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out; returns 0 or an error code.
int nms_suppress_max_clusters(int k, int cluster, int device, int* out) {
  *out = 0;
  if (!plan_ok(1, k, cluster)) return kErrPlan;
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaError_t e = prepare(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, k, cluster, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, nms_suppress_kernel, &cfg));
}

const char* nms_suppress_error_string(int err) {
  if (err == kErrPlan) {
    return "the plan or the inputs are outside what the kernel takes (bs, "
           "k <= 1024, cluster <= 16 and <= k / 32, shared memory, 16-byte "
           "alignment of the boxes)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
