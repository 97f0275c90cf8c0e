// The activations of the int8 convs' f32 epilogue, shared by K2
// (conv_int8.cu) and K4 (depthwise_int8.cu). The codes are ACT_CODES of
// yolo_tpu_torch/ops/conv_int8.py.

#pragma once

#include <cuda_runtime.h>

namespace {

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

}  // namespace
