"""Model loading and the float inference pipeline (counterpart of
yolo_tpu/runtime.py): build the IR, initialise or load weights (.npz
checkpoints of the JAX package, darknet .weights), fold BN, and return a
forward + decode + NMS callable on an explicit device.

Quantized models, test-time augmentation and .pt weights are not ported
yet (see ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yolo_tpu.ir import NetworkIR, build_ir
from yolo_tpu.utils.checkpoint import load_checkpoint

from .convert import from_jax
from .models.darknet_io import load_darknet_weights
from .models.network import Darknet, fuse_params, init_params
from .ops.nms import non_max_suppression, non_max_suppression_heads


@dataclass
class ModelBundle:
    """A detector's IR, weights and placement.

    ``params``/``state`` are dicts of f32 tensors on ``device`` (see
    ``models/network.py``); an empty ``state`` means BN is folded.
    ``dtype`` is the compute dtype of the forward."""
    net: NetworkIR
    params: dict
    state: dict
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    maxabsscaler: bool = False

    @property
    def nc(self) -> int:
        return self.net.nc

    @property
    def strides(self):
        return [l.yolo_stride for l in self.net.layers if l.kind == 'yolo']

    def fuse(self) -> 'ModelBundle':
        """Fold conv BN into the weights; returns a new bundle."""
        return ModelBundle(net=self.net,
                           params=fuse_params(self.net, self.params, self.state),
                           state={}, device=self.device, dtype=self.dtype,
                           maxabsscaler=self.maxabsscaler)

    def model(self) -> Darknet:
        """The eval-mode ``Darknet`` in ``dtype``, channels_last, on ``device``."""
        m = Darknet(self.net, self.params, self.state, fused=not self.state,
                    maxabsscaler=self.maxabsscaler, dtype=self.dtype)
        return m.to(self.device, memory_format=torch.channels_last).eval()

    def make_infer(self, conf_thres=0.3, iou_thres=0.6, top_k=512,
                   max_det=300, multi_label=True, agnostic=False,
                   augment=False, sparse=False, classes=None):
        """Forward + decode + batched NMS as one callable:
        ``infer(x)`` with x an NHWC float batch on ``device`` returns
        (bs, max_det, 6) detections.

        ``sparse`` selects the sparse-decode NMS from the raw head maps
        (``non_max_suppression_heads``, cell mode via the slim objectness
        conv) over the dense decode of every anchor box. Dense is the
        default: on an H100 it measured faster for yolov3 @608 bs=8
        (PERF.md)."""
        if augment:
            raise NotImplementedError('test-time augmentation is not ported to '
                                      'yolo_tpu_torch yet (see ROADMAP.md)')
        model = self.model()
        kw = dict(conf_thres=conf_thres, iou_thres=iou_thres, top_k=top_k,
                  max_det=max_det, multi_label=multi_label, agnostic=agnostic,
                  classes=classes)
        if sparse:
            anchors = model.anchors()
            strides = self.strides

            @torch.inference_mode()
            def infer(x):
                heads, objs = model.forward_heads(x)
                return non_max_suppression_heads(heads, anchors, strides,
                                                 self.nc + 5, objs=objs, **kw)
        else:
            @torch.inference_mode()
            def infer(x):
                return non_max_suppression(model(x), **kw)
        return infer


def load_model(cfg, weights=None, *, device='cpu', dtype=torch.bfloat16,
               quantized: int = -1, is_gray_scale: bool = False,
               maxabsscaler: bool = False,
               generator: torch.Generator | None = None,
               conv_scale: float = 1.0) -> ModelBundle:
    """Build a float detector on ``device`` and load its weights.

    ``weights``: a .npz checkpoint of the JAX package (its EMA params and
    BN state when it holds both, as inference in the JAX package loads
    them) or darknet .weights; None or '' keeps the random init of
    ``init_params(generator, conv_scale)``."""
    if quantized != -1:
        raise NotImplementedError('quantized models are not ported to '
                                  'yolo_tpu_torch yet (see ROADMAP.md)')
    net = build_ir(cfg, is_gray_scale=is_gray_scale)
    params, state = init_params(net, generator, conv_scale=conv_scale)

    if weights and weights != 'None':
        w = str(weights)
        if w.endswith('.npz'):
            ck = load_checkpoint(w)
            src_params, src_state = ck['params'], ck['state']
            if ck.get('ema') is not None and ck.get('ema_state') is not None:
                src_params, src_state = ck['ema'], ck['ema_state']
            src_params, src_state = from_jax(net, src_params, src_state)
            params = _merge_compatible(params, src_params)
            state = _merge_compatible(state, src_state)
        elif w.endswith(('.pt', '.pth')):
            raise NotImplementedError('.pt weights are not ported to '
                                      'yolo_tpu_torch yet (see ROADMAP.md)')
        else:
            params, state, _, _ = load_darknet_weights(net, params, state, w)
    device = torch.device(device)
    to = lambda tree: {k: {f: t.to(device) for f, t in d.items()}
                       for k, d in tree.items()}
    return ModelBundle(net=net, params=to(params), state=to(state),
                       device=device, dtype=dtype, maxabsscaler=maxabsscaler)


def _merge_compatible(dst, src):
    """Take the entries of ``src`` whose shapes match ``dst`` (and new ones)."""
    out = {k: dict(v) for k, v in dst.items()}
    for k, d in (src or {}).items():
        if k not in out:
            out[k] = dict(d)
            continue
        for f, v in d.items():
            if f not in out[k] or out[k][f].shape == v.shape:
                out[k][f] = v
    return out


def preprocess(imgs_uint8, maxabsscaler: bool = False, device='cpu'):
    """uint8 NHWC batch -> float32 input on ``device``: x / 256, or mapped
    to (-1, 1) under ``maxabsscaler``. The batch crosses to the device as
    uint8 and is normalised there."""
    x = imgs_uint8 if torch.is_tensor(imgs_uint8) else torch.from_numpy(
        np.ascontiguousarray(imgs_uint8))
    x = x.to(device, non_blocking=True).to(torch.float32) / 256.0
    return x * 2.0 - 1.0 if maxabsscaler else x
