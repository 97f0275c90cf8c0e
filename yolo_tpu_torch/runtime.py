"""Model loading and the inference pipelines (counterpart of
yolo_tpu/runtime.py): build the IR, initialise or load weights (.npz
checkpoints of the JAX package, darknet .weights, .pt checkpoints of the
PyTorch reference), and return a forward + decode + NMS callable on an
explicit device.

Float models: ``load_model`` -> ``fuse`` (BN folded) -> ``make_infer``.
Quantized models (``quantized=1..6``: google, tpsq, ptq_cos, dorefa, wbin,
ternary): ``load_model`` attaches a quantizer config and state (and TPSQ's
scale params); ``apply(x, train=True)`` is one calibration step;
``make_infer`` runs the true-int8 engine (the default for google and
ptq_cos; TPSQ when asked) or the fake-quant sim.

Every entry point runs on the card (``device='cuda'``) unless the caller
asks for the CPU.
"""

from __future__ import annotations

import os
from collections import OrderedDict
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
from .ops.conv_int8 import float_edge_conv, grouped_conv_int8
from .ops.nms import non_max_suppression, non_max_suppression_heads
from .parallel.mesh import DATA_AXIS, replicate
from .utils.checkpoint import load_checkpoint
from .utils.profiler import count, span, totals, tracing

#: the most input shapes whose serving step a callable keeps as CUDA graphs
GRAPHS_KEPT = 4


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
                   augment=False, sparse=False, classes=None, engine=None,
                   mesh=None):
        """Forward + decode + batched NMS as one callable:
        ``infer(x)`` with x an NHWC float batch on ``device`` returns
        (bs, max_det, 6) detections. Each call is one top-level span
        ``serve.infer`` (``utils/profiler.py``).

        Float bundles: ``sparse`` selects the sparse-decode NMS from the raw
        head maps (``non_max_suppression_heads``, cell mode via the slim
        objectness conv) over the dense decode of every anchor box. Dense
        is the default: on an H100 it measured faster for yolov3 @608 bs=8
        (PERF.md). ``augment`` runs test-time augmentation
        (``Darknet.forward_augment``: the input, its flip at 0.83 and its
        0.67 scale, merged) into the dense NMS.

        Quantized bundles: ``engine`` (default: on for the google and
        ptq_cos schemes, on every device; TPSQ takes it when asked, the
        other schemes have none) runs the true-int8 engine with its int8
        heads into the sparse NMS (``head_scales``); ``engine=False`` runs
        the f32 fake-quant sim and the dense NMS. The plan of the engine is
        prepared here, from the current calibration; ``augment`` prints a
        warning and runs a single pass, as in the JAX package.

        The engine's step (the engine, the sparse decode, K1 and the
        ranking into ``max_det`` slots) is replayed as one CUDA graph
        where the call allows it: ``x`` on a CUDA device, no ``mesh``, no
        ``torch.profiler`` session on (so that every span measures its
        layer), and the (shape, dtype, device) of ``x`` that the previous
        call had. The first call of a shape runs eagerly, the next one
        captures the step, later ones copy ``x`` into the graph's input and
        replay it; a shape that changes on every call runs eagerly. At most
        ``GRAPHS_KEPT`` shapes keep a graph, the least recently used is
        dropped. A replay launches exactly the eager step's kernels on the
        same inputs, so its detections are bit-equal; it adds to every
        always-on counter (``k1.launches`` ... ``k4.launches``,
        ``grouped.calls``, ``float_edge.calls``, ``nms.slots``) and to the
        ``.calls`` attributes what one eager step adds. Each call adds one
        to ``serve.eager_calls``, ``serve.graph_captures`` or
        ``serve.graph_replays``. The returned tensor is the caller's own,
        eager or replayed: a later call never writes into it.

        ``mesh`` (``parallel.make_mesh``, spatial partitioning): every rank
        of the mesh's data axis calls ``infer`` on its rows of the image
        (``parallel.shard_spatial(mesh, x)``); each layer takes its halo
        rows from its neighbours, the head maps are gathered whole, and
        every rank decodes and runs the NMS on the whole image, so it
        returns one process's detections. This holds for every path above:
        the float forward (dense or sparse), test-time augmentation (the
        input's rows gathered once, each pass run on this rank's rows of
        its flipped or scaled image), the fake-quant sim, and the int8
        engine (int8 halo rows; K2 on stride-aligned blocks of rows, its
        int8 heads gathered into the sparse NMS). H (and each TTA pass's H)
        must divide by the data axis times the deepest stride. A quantized
        bundle serves rank 0's weights, BN statistics and calibration:
        they are broadcast over the data axis here, before the engine's
        plan is prepared, so that every rank quantizes on one grid (a
        calibration run on each rank may set the pow-2 scales apart)."""
        spatial = None
        if mesh is not None and mesh.shape[DATA_AXIS] > 1:
            spatial = mesh.data_group
            if self.quantized:
                replicate(mesh, (self.params, self.state, self.qstate))
        if augment and self.quantized:
            print('WARNING: --augment (TTA) is not supported with quantized '
                  'inference; running single-pass')
        kw = dict(conf_thres=conf_thres, iou_thres=iou_thres, top_k=top_k,
                  max_det=max_det, multi_label=multi_label, agnostic=agnostic,
                  classes=classes)
        if self.quantized:
            return self._make_quant_infer(kw, engine, spatial,
                                          graphs=mesh is None)
        model = self.model()
        if augment:
            @torch.inference_mode()
            def infer(x):
                with span('serve.infer'):
                    return non_max_suppression(
                        model.forward_augment(x, spatial=spatial), **kw)
        elif sparse:
            anchors = model.anchors()
            strides = self.strides

            @torch.inference_mode()
            def infer(x):
                with span('serve.infer'):
                    heads, objs = model.forward_heads(x, spatial=spatial)
                    return non_max_suppression_heads(
                        heads, anchors, strides, self.nc + 5, objs=objs, **kw)
        else:
            @torch.inference_mode()
            def infer(x):
                with span('serve.infer'):
                    return non_max_suppression(
                        model.decode(model.heads(x, spatial=spatial)), **kw)
        return infer

    def _make_quant_infer(self, kw, engine, spatial, graphs):
        if engine is None:
            engine = self.qcfg.scheme in ('google', 'ptq_cos')
        if not engine:
            sim = self.quant_apply()
            params, state, qstate = self.params, self.state, self.qstate

            @torch.inference_mode()
            def infer(x):
                with span('serve.infer'):
                    return non_max_suppression(
                        sim(params, state, qstate, x, spatial=spatial)[0],
                        **kw)
            return infer
        plan = prepare_int8(self.net, self.params, self.state, self.qstate,
                            self.qcfg, device=self.device)
        eng = make_int8_apply(self.net, plan, heads_only=True,
                              spatial=spatial)
        anchors, strides = self.anchors(), self.strides

        def step(x):
            with span('serve.infer'):
                heads, objs = eng(plan.arrays, x)
                return non_max_suppression_heads(
                    heads, anchors, strides, self.nc + 5, objs=objs,
                    head_scales=eng.head_scales, **kw)
        if graphs:
            return StepGraphs(step)

        @torch.inference_mode()
        def infer(x):
            count('serve.eager_calls', 1)
            return step(x)
        return infer


# the engine's conv paths that count their calls in a ``.calls`` attribute
_CALLS = {'grouped_conv_int8.calls': grouped_conv_int8,
          'float_edge_conv.calls': float_edge_conv}


def _tally() -> dict:
    """The always-on counters and the ``.calls`` attributes, by name."""
    return {**totals(), **{k: f.calls for k, f in _CALLS.items()}}


def _added(before: dict, after: dict) -> list:
    """What the ``_tally`` ``after`` holds over ``before``, as (name,
    value) pairs."""
    return [(k, v - before.get(k, 0)) for k, v in after.items()
            if v != before.get(k, 0)]


def _add(adds):
    """Add the (name, value) pairs of ``_added`` again."""
    for k, v in adds:
        if k in _CALLS:
            _CALLS[k].calls += v
        else:
            count(k, v)


class StepGraphs:
    """A serving step ``step(x)`` replayed as CUDA graphs, one an input
    (shape, dtype, device), under the rules of ``make_infer``'s docstring.
    ``graphs`` maps each key kept to its ``_Graph``, the most recently used
    last; ``last`` is the previous call's key."""

    def __init__(self, step):
        self.step = step
        self.graphs: OrderedDict = OrderedDict()
        self.last = None

    @torch.inference_mode()
    def __call__(self, x):
        key = (tuple(x.shape), x.dtype, x.device)
        prev, self.last = self.last, key
        if x.is_cuda and not tracing():
            g = self.graphs.get(key)
            if g is not None:
                self.graphs.move_to_end(key)
                out = g.replay(x)
                count('serve.graph_replays', 1)
                return out
            if key == prev:
                g = self.graphs[key] = _Graph(self.step, x)
                if len(self.graphs) > GRAPHS_KEPT:
                    self.graphs.popitem(last=False)
                count('serve.graph_captures', 1)
                return g.out.clone()
        count('serve.eager_calls', 1)
        return self.step(x)


class _Graph:
    """``step`` captured on a copy of ``x``, then replayed once for ``x``'s
    output (``out``, the graph's own tensor). ``adds`` is what the capture
    added to the always-on counters and the ``.calls`` attributes, one
    eager step's worth, which each later replay adds again: Python does not
    run on a replay. Captured in ``thread_local`` mode, so that another
    thread's CUDA work (a loader's pinned copies) goes on meanwhile."""

    def __init__(self, step, x):
        dev = x.device
        self.x = torch.empty_like(x).copy_(x)
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = _tally()
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode='thread_local')
            try:
                self.out = step(self.x)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.adds = _added(before, _tally())
        self.graph.replay()

    def replay(self, x):
        """Copy ``x`` into the graph's input, replay it, add one step to
        the counters; the caller's own copy of the output."""
        self.x.copy_(x)
        self.graph.replay()
        _add(self.adds)
        return self.out.clone()


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

    ``quantized``: -1 float; 1 google, 2 tpsq, 3 ptq_cos, 4 dorefa, 5 wbin,
    6 ternary (``compress/quant.SCHEMES``), with ``a_bit``/``w_bit``,
    ``shortcut_way`` and ``steps`` (the calibration or training length that
    sets the freeze steps). Its quantizer state comes from the checkpoint's
    ``qstate`` key or from a sibling ``<name>_qstate.npz``, else it starts
    uncalibrated; TPSQ's scale params (``w_scale``/``b_scale``/``a_scale``
    of each conv) start at 1.0 unless the checkpoint holds them;
    ``eval_snap_dtype`` (e.g. ``torch.bfloat16``) runs the sim's eval grid
    snaps in that dtype."""
    device = torch.device(device)
    net = build_ir(cfg, is_gray_scale=is_gray_scale)
    params, state = init_params(net, generator, conv_scale=conv_scale)
    qcfg = qstate = None
    if quantized != -1:
        if quantized not in SCHEMES:
            raise ValueError(f'quantized={quantized}: not one of -1, '
                             f'{", ".join(map(str, SCHEMES))}')
        qcfg = QuantConfig(scheme=SCHEMES[quantized], a_bits=a_bit,
                           w_bits=w_bit, shortcut_way=shortcut_way,
                           maxabsscaler=maxabsscaler, steps=steps)
        qstate, extra = init_quant_state(net, qcfg)
        for k, v in extra.items():
            params[k] = {**params[k], **v}

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
