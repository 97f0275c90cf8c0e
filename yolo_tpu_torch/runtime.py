"""Model loading and the inference pipelines (counterpart of
yolo_tpu/runtime.py): build the IR, initialise or load weights (.npz
checkpoints of the JAX package, darknet .weights, .pt checkpoints of the
PyTorch reference), and return a forward + decode + NMS callable on an
explicit device.

Float models: ``load_model`` -> ``fuse`` (BN folded) -> ``make_infer``.
Quantized models (``quantized=1``, the google scheme): ``load_model``
attaches a quantizer config and state; ``apply(x, train=True)`` is one
calibration step; ``make_infer`` runs the true-int8 engine (default) or the
fake-quant sim (``engine=False``).

Every entry point runs on the card (``device='cuda'``) unless the caller
asks for the CPU. Other quantization schemes are not ported yet (see
ROADMAP.md).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .compress.quant import (SCHEMES, QuantConfig, init_quant_state,
                             make_quant_apply)
from .convert import from_jax, qstate_from_jax
from .ir import NetworkIR, build_ir
from .models.darknet_io import load_darknet_weights
from .models.int8_engine import make_int8_apply, prepare_int8
from .models.network import Darknet, fuse_params, init_params
from .models.torch_import import load_torch_checkpoint
from .ops.nms import non_max_suppression, non_max_suppression_heads
from .utils.checkpoint import load_checkpoint


@dataclass
class ModelBundle:
    """A detector's IR, weights and placement.

    ``params``/``state`` are dicts of f32 tensors on ``device`` (see
    ``models/network.py``); an empty ``state`` means BN is folded.
    ``dtype`` is the compute dtype of the float forward. A quantized
    bundle also holds ``qcfg`` and ``qstate`` (``compress/quant.py``) and
    the dtype of its sim's eval grid snaps (``eval_snap_dtype``, None for
    f32)."""
    net: NetworkIR
    params: dict
    state: dict
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    maxabsscaler: bool = False
    qcfg: QuantConfig | None = None
    qstate: dict | None = None
    eval_snap_dtype: torch.dtype | None = None

    @property
    def nc(self) -> int:
        return self.net.nc

    @property
    def strides(self):
        return [l.yolo_stride for l in self.net.layers if l.kind == 'yolo']

    @property
    def quantized(self) -> bool:
        return self.qcfg is not None

    def fuse(self) -> 'ModelBundle':
        """Fold conv BN into the weights; returns a new float bundle."""
        if self.quantized:
            raise ValueError('a quantized bundle folds BN in its own apply: '
                             'call make_infer on it directly')
        return ModelBundle(net=self.net,
                           params=fuse_params(self.net, self.params, self.state),
                           state={}, device=self.device, dtype=self.dtype,
                           maxabsscaler=self.maxabsscaler)

    def model(self) -> Darknet:
        """The eval-mode ``Darknet`` in ``dtype``, channels_last, on ``device``."""
        m = Darknet(self.net, self.params, self.state, fused=not self.state,
                    maxabsscaler=self.maxabsscaler, dtype=self.dtype)
        return m.to(self.device, memory_format=torch.channels_last).eval()

    @torch.no_grad()
    def apply(self, x, train: bool = False):
        """The fake-quant sim on an NHWC f32 batch (quantized bundles).

        ``train=True`` is one calibration step: range trackers, scales and
        BN statistics update, and the bundle's ``state`` and ``qstate`` are
        replaced by the new ones; returns (yolo_p, feats). Eval returns
        (io, yolo_p, feats)."""
        if not self.quantized:
            raise ValueError('apply is the quantized sim: load the model '
                             'with quantized=1')
        fn = self.quant_apply()
        if not train:
            return fn(self.params, self.state, self.qstate, x, False)
        out, self.state, self.qstate = fn(self.params, self.state,
                                          self.qstate, x, True)
        return out

    def quant_apply(self):
        """The bundle's fake-quant sim (``make_quant_apply`` with its eval
        snap dtype)."""
        return make_quant_apply(self.net, self.qcfg,
                                eval_snap_dtype=self.eval_snap_dtype)

    def anchors(self):
        """Per-scale (na, 2) pixel anchors, f32, on ``device``."""
        return [torch.as_tensor(l.anchors, dtype=torch.float32,
                                device=self.device)
                for l in self.net.layers if l.kind == 'yolo']

    def make_infer(self, conf_thres=0.3, iou_thres=0.6, top_k=512,
                   max_det=300, multi_label=True, agnostic=False,
                   augment=False, sparse=False, classes=None, engine=None):
        """Forward + decode + batched NMS as one callable:
        ``infer(x)`` with x an NHWC float batch on ``device`` returns
        (bs, max_det, 6) detections.

        Float bundles: ``sparse`` selects the sparse-decode NMS from the raw
        head maps (``non_max_suppression_heads``, cell mode via the slim
        objectness conv) over the dense decode of every anchor box. Dense
        is the default: on an H100 it measured faster for yolov3 @608 bs=8
        (PERF.md). ``augment`` runs test-time augmentation
        (``Darknet.forward_augment``: the input, its flip at 0.83 and its
        0.67 scale, merged) into the dense NMS.

        Quantized bundles: ``engine`` (default: on, for the google scheme,
        on every device) runs the true-int8 engine with its int8 heads
        into the sparse NMS (``head_scales``); ``engine=False`` runs the
        f32 fake-quant sim and the dense NMS. The plan of the engine is
        prepared here, from the current calibration; ``augment`` prints a
        warning and runs a single pass, as in the JAX package."""
        if augment and self.quantized:
            print('WARNING: --augment (TTA) is not supported with quantized '
                  'inference; running single-pass')
        kw = dict(conf_thres=conf_thres, iou_thres=iou_thres, top_k=top_k,
                  max_det=max_det, multi_label=multi_label, agnostic=agnostic,
                  classes=classes)
        if self.quantized:
            return self._make_quant_infer(kw, engine)
        model = self.model()
        if augment:
            @torch.inference_mode()
            def infer(x):
                return non_max_suppression(model.forward_augment(x), **kw)
        elif sparse:
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

    def _make_quant_infer(self, kw, engine):
        if engine is None:
            engine = self.qcfg.scheme == 'google'
        if not engine:
            sim = self.quant_apply()
            params, state, qstate = self.params, self.state, self.qstate

            @torch.inference_mode()
            def infer(x):
                return non_max_suppression(sim(params, state, qstate, x)[0],
                                           **kw)
            return infer
        plan = prepare_int8(self.net, self.params, self.state, self.qstate,
                            self.qcfg, device=self.device)
        eng = make_int8_apply(self.net, plan, heads_only=True)
        anchors, strides = self.anchors(), self.strides

        @torch.inference_mode()
        def infer(x):
            heads, objs = eng(plan.arrays, x)
            return non_max_suppression_heads(
                heads, anchors, strides, self.nc + 5, objs=objs,
                head_scales=eng.head_scales, **kw)
        return infer


def load_model(cfg, weights=None, *, device='cuda', dtype=torch.bfloat16,
               quantized: int = -1, a_bit: int = 8, w_bit: int = 8,
               shortcut_way: int = 1, steps: int = 0,
               is_gray_scale: bool = False, maxabsscaler: bool = False,
               generator: torch.Generator | None = None,
               conv_scale: float = 1.0, pt: bool = False,
               prefer_ema: bool = True,
               eval_snap_dtype: torch.dtype | None = None) -> ModelBundle:
    """Build a detector on ``device`` and load its weights.

    ``weights``: a .npz checkpoint of the JAX package, a .pt/.pth
    checkpoint of the PyTorch reference (``models/torch_import.py``; its
    quantizer trackers restore ``qstate``) or darknet .weights (``pt``
    skips the 255-channel heads of a pretrained file); None or '' keeps
    the random init of ``init_params(generator, conv_scale)``. A .npz that
    holds both the raw params/state and the EMA pair loads the EMA pair
    unless ``prefer_ema`` is False (the raw trajectory, as a resume needs).

    ``quantized``: -1 float; 1 the google scheme with ``a_bit``/``w_bit``,
    ``shortcut_way`` and ``steps`` (the calibration length that sets the
    freeze steps). Its quantizer state comes from the checkpoint's
    ``qstate`` key or from a sibling ``<name>_qstate.npz``, else it starts
    uncalibrated; ``eval_snap_dtype`` (e.g. ``torch.bfloat16``) runs its
    sim's eval grid snaps in that dtype. Other schemes raise
    NotImplementedError."""
    device = torch.device(device)
    net = build_ir(cfg, is_gray_scale=is_gray_scale)
    params, state = init_params(net, generator, conv_scale=conv_scale)
    qcfg = qstate = None
    if quantized != -1:
        scheme = SCHEMES.get(quantized)
        if scheme != 'google':
            raise NotImplementedError(
                f'quantized={quantized} ({scheme}) is not ported to '
                'yolo_tpu_torch yet (see ROADMAP.md)')
        qcfg = QuantConfig(scheme=scheme, a_bits=a_bit, w_bits=w_bit,
                           shortcut_way=shortcut_way,
                           maxabsscaler=maxabsscaler, steps=steps)
        qstate = init_quant_state(net, qcfg)[0]

    if weights and weights != 'None':
        w = str(weights)
        if w.endswith('.npz'):
            ck = load_checkpoint(w)
            src_params, src_state = ck['params'], ck['state']
            if (prefer_ema and ck.get('ema') is not None
                    and ck.get('ema_state') is not None):
                src_params, src_state = ck['ema'], ck['ema_state']
            src_params, src_state = from_jax(net, src_params, src_state)
            params = _merge_compatible(params, src_params)
            state = _merge_compatible(state, src_state)
            if qstate is not None:
                saved = ck.get('qstate')
                sibling = w[:-len('.npz')] + '_qstate.npz'
                if saved is None and os.path.exists(sibling):
                    saved = load_checkpoint(sibling)['params']
                if saved is not None:
                    qstate = _merge_tree(qstate, qstate_from_jax(saved))
        elif w.endswith(('.pt', '.pth')):
            params, state, qstate, _ = load_torch_checkpoint(
                net, params, state, w, qstate=qstate)
        else:
            params, state, _, _ = load_darknet_weights(net, params, state, w,
                                                       pt=pt)
    to = lambda tree: {k: {f: t.to(device) for f, t in d.items()}
                       for k, d in tree.items()}
    if qstate is not None:
        qstate = _to_device(qstate, device)
    return ModelBundle(net=net, params=to(params), state=to(state),
                       device=device, dtype=dtype, maxabsscaler=maxabsscaler,
                       qcfg=qcfg, qstate=qstate,
                       eval_snap_dtype=eval_snap_dtype if qcfg else None)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


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


def _merge_tree(dst, src):
    """Shape-checked restore of a nested quantizer state: leaves of ``src``
    whose shapes match ``dst`` replace them; unknown keys are added."""
    if isinstance(dst, dict) and isinstance(src, dict):
        out = dict(dst)
        for k, v in src.items():
            out[k] = _merge_tree(dst[k], v) if k in dst else v
        return out
    return src if dst.shape == src.shape else dst


def preprocess(imgs_uint8, maxabsscaler: bool = False, device='cuda'):
    """uint8 NHWC batch -> float32 input on ``device``: x / 256, or mapped
    to (-1, 1) under ``maxabsscaler``. The batch crosses to the device as
    uint8 and is normalised there."""
    x = imgs_uint8 if torch.is_tensor(imgs_uint8) else torch.from_numpy(
        np.ascontiguousarray(imgs_uint8))
    x = x.to(device, non_blocking=True).to(torch.float32) / 256.0
    return x * 2.0 - 1.0 if maxabsscaler else x
