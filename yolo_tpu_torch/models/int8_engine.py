"""True-int8 inference engine (counterpart of yolo_tpu/models/int8_engine.py).

The fake-quant sim (``compress/quant.py``) simulates integer arithmetic in
float. This engine runs the calibrated model with int8 tensors end to end:

  - conv weights are pre-quantized to int8 (BN folded, pow-2 scale) and
    stored (Cout, K, K, Cin), the order kernel K2 reads them in;
  - activations travel between layers as int8 NHWC tensors with a per-edge
    pow-2 scale;
  - every conv on an int8 edge runs K2 (``ops/conv_int8.fused_conv_int8``:
    s8 x s8 -> s32 and a fused f32 epilogue of scale, bias, activation and
    requantization to the layer's own output scale), the arithmetic the
    sim models;
  - shortcuts and concats follow the sim's requantization chains (min/max
    shortcut ways, a common concat scale) in f32.

The network input is a float edge: the first conv runs on the bf16-rounded
input and the dequantized int8 weights, summed in f32 (cuDNN on the card),
then requantizes. Scales are read from a calibrated qstate when the plan is
prepared and baked in as Python floats.

The JAX package's TPU backend menu ('mixed'/'auto') is not carried over:
every int8 conv goes through K2, which is the JAX ``backend='pallas'``
routing with ``pallas_min_hw=0`` (its oracle is ``backend='xla'``).

Not ported yet (see ROADMAP.md): schemes other than google, grouped or
other convs K2 does not take on int8 edges, and the float fallback edges
(SE, avgpool, scale_channels, standalone batchnorm).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..compress.quant import (QuantConfig, check_supported, qrange,
                              round_half_away, unported)
from ..ir import NetworkIR
from ..ops import activations as act_mod
from ..ops import conv as conv_ops
from ..ops.conv_int8 import fused_conv_int8, supported
from .yolo_head import anchors_on, decode_yolo_nhwc, reshape_pred

BN_EPS = 1e-5


class Int8Plan(NamedTuple):
    arrays: dict            # {layer_key: {'w8': int8 (Cout,K,K,Cin), 'bias': f32}}
    meta: dict              # {layer_key: {'sw','sa'} | {'in_scale','sc'} | {'rs'}}
    a_bits: int
    shortcut_way: int
    maxabsscaler: bool
    scheme: str = 'google'


def _q_arr(x, scale, bits):
    qmin, qmax = qrange(bits, True)
    return np.clip(np.sign(x) * np.floor(np.abs(x) / scale + 0.5),
                   qmin, qmax).astype(np.int8 if bits <= 8 else np.int32)


def _np64(t):
    return np.asarray(t.detach().cpu() if torch.is_tensor(t) else t,
                      np.float64)


def _scalar(v) -> float:
    """A qstate scale (0-d tensor, or 0-d array from a .npz) as a float."""
    return float(v.item() if torch.is_tensor(v) else np.asarray(v))


def prepare_int8(net: NetworkIR, params, state, qstate, cfg: QuantConfig,
                 device=None) -> Int8Plan:
    """Fold BN, quantize weights/biases to integers, extract frozen scales.

    The eval path of the sim, in float64 numpy as in the JAX package:
    w_fold = w * gamma/sqrt(var+eps), bias = beta - mean*inv (+ b*inv),
    both quantized with their tracker scales; the plan holds the int8
    weights and the dequantized f32 bias the epilogue adds, on ``device``
    (default: that of the params)."""
    check_supported(net, cfg.scheme)
    if device is None:
        device = next(iter(next(iter(params.values())).values())).device
    arrays: dict[str, dict] = {}
    meta: dict[str, dict] = {}
    for lyr in net.layers:
        k = str(lyr.index)
        if lyr.kind == 'conv':
            p = {f: _np64(v) for f, v in params[k].items()}
            if lyr.bn:
                inv = p['gamma'] / np.sqrt(_np64(state[k]['var']) + BN_EPS)
                w_fold = p['w'] * inv[:, None, None, None]         # OIHW
                bias = p['beta'] + (p.get('b', 0.0) - _np64(state[k]['mean'])) * inv
            else:
                w_fold = p['w']
                bias = p.get('b', np.zeros(lyr.filters))
            qs = qstate[k]
            sw = _scalar(qs['wq']['scale'])
            sb = _scalar(qs['bq']['scale'])
            sa = _scalar(qs['aq']['scale'])
            w8 = _q_arr(w_fold, sw, cfg.w_bits).transpose(0, 2, 3, 1)
            bias_dq = _q_arr(bias, sb, cfg.w_bits).astype(np.float32) * sb
            arrays[k] = {
                'w8': torch.from_numpy(np.ascontiguousarray(w8)).to(device),
                'bias': torch.from_numpy(
                    np.asarray(bias_dq, np.float32)).to(device)}
            meta[k] = {'sw': sw, 'sa': sa}
        elif lyr.kind == 'shortcut':
            qs = qstate[k]
            meta[k] = {'in_scale': _scalar(qs['input_scale' if cfg.shortcut_way
                                              == 1 else 'scale']),
                       'sc': _scalar(qs['scale'])}
            if lyr.weighted:
                arrays[k] = {'w': params[k]['w'].detach().to(
                    device, torch.float32)}
        elif lyr.kind == 'route' and len(lyr.layers) > 1:
            meta[k] = {'rs': _scalar(qstate[k]['scale'])}
    return Int8Plan(arrays=arrays, meta=meta, a_bits=cfg.a_bits,
                    shortcut_way=cfg.shortcut_way,
                    maxabsscaler=cfg.maxabsscaler, scheme=cfg.scheme)


# a carried edge: ('q', int8 NHWC tensor, scale) | ('f', f32 NHWC tensor)

def _as_float(t):
    if t[0] == 'f':
        return t[1].to(torch.float32)
    return t[1].to(torch.float32) * t[2]


def make_int8_apply(net: NetworkIR, plan: Int8Plan, heads_only: bool = False,
                    conv=fused_conv_int8):
    """Build apply(arrays, x) -> (io, yolo_p) on an NHWC f32 batch x.
    Inference only.

    ``heads_only``: return (head_out, obj_out) instead: the int8 NHWC head
    tensors (``apply.head_scales`` holds their per-scale dequant factors)
    and per-scale objectness-logit maps (the strided obj-channel slice of
    the int8 head, dequantized) for the sparse NMS
    (``ops/nms.non_max_suppression_heads(..., head_scales=...)``), which
    dequantizes only the rows it gathers.

    ``conv``: the int8 conv, K2 (``fused_conv_int8``) by default; pass its
    plain version (``fused_conv_int8_reference``) to hold one against the
    other on the card."""
    check_supported(net, plan.scheme)
    layers = net.layers
    bits = plan.a_bits
    qmin, qmax = qrange(bits, True)
    meta = plan.meta

    def requant_edge(t, scale):
        """Requantize a carried edge to ``scale`` (saturating); multiplies
        by the exact pow-2 inverse."""
        if t[0] == 'q' and t[2] == scale:
            return t
        y = round_half_away(_as_float(t) * (1.0 / scale))
        return ('q', torch.clamp(y, qmin, qmax).to(torch.int8), scale)

    def conv_i8(lyr, arr, t):
        stride = lyr.stride_xy or lyr.stride
        m = meta[str(lyr.index)]
        if t[0] == 'q':
            if (isinstance(stride, (tuple, list))
                    or not supported(lyr.size, stride, lyr.pad, lyr.groups)):
                raise unported(f'layer {lyr.index}: int8 conv k={lyr.size} '
                               f's={stride} pad={lyr.pad} '
                               f'groups={lyr.groups}')
            q = conv(t[1], arr['w8'], arr['bias'], t[2] * m['sw'], m['sa'],
                     stride=stride, act=lyr.activation,
                     maxabs=plan.maxabsscaler, out_q=True, qmin=qmin,
                     qmax=qmax)
            return ('q', q, m['sa'])
        # float edge (the network input): the conv of the bf16-rounded input
        # with the dequantized int8 weights (exact in bf16), summed and
        # kept in f32. That is the JAX engine as its jitted program computes
        # it: XLA keeps the bf16 conv's f32 sums without rounding them to
        # bf16 (its eager op does round them).
        wf = arr['w8'].permute(0, 3, 1, 2).to(torch.float32) * m['sw']
        xb = t[1].to(torch.bfloat16).to(torch.float32)
        y = conv_ops.conv2d_nhwc(xb, wf, stride=stride, padding=lyr.pad,
                                 groups=lyr.groups)
        y = y + arr['bias']
        y = act_mod.get(lyr.activation, plan.maxabsscaler)(y)
        q = torch.clamp(round_half_away(y * (1.0 / m['sa'])), qmin, qmax)
        return ('q', q.to(torch.int8).contiguous(), m['sa'])

    def shortcut_i8(lyr, arr, t, outs):
        """The sim's requantization chain in f32; scales are pow-2, so the
        inverses are exact and every fake-quant is a multiply."""
        m = meta[str(lyr.index)]
        in_s, inv_in = m['in_scale'], 1.0 / m['in_scale']
        sc, inv_sc = m['sc'], 1.0 / m['sc']
        ws = None
        if lyr.weighted:
            ws = torch.sigmoid(arr['w']) * (2.0 / (len(lyr.layers) + 1))
        x = _as_float(t)
        if ws is not None:
            x = x * ws[0]
        for i, j in enumerate(lyr.layers):
            a = _as_float(outs[j])
            if ws is not None:
                a = a * ws[i + 1]
            if plan.shortcut_way == 2:      # max way: saturating fake-quant
                xq = torch.clamp(round_half_away(x * inv_in), qmin, qmax) * in_s
                aq = torch.clamp(round_half_away(a * inv_in), qmin, qmax) * in_s
            else:                            # min way: round, no clamp
                xq = round_half_away(x * inv_in) * in_s
                aq = round_half_away(a * inv_in) * in_s
            nx_, na_ = xq.shape[-1], aq.shape[-1]
            if nx_ == na_:
                s = xq + aq
            elif nx_ > na_:
                s = torch.cat([xq[..., :na_] + aq, xq[..., na_:]], -1)
            else:
                s = xq + aq[..., :nx_]
            x = torch.clamp(round_half_away(s * inv_sc), qmin, qmax) * sc
        q = torch.clamp(round_half_away(x * inv_sc), qmin, qmax)
        return ('q', q.to(torch.int8), sc)

    # static per-yolo head dequant scales: each yolo layer directly follows
    # its head conv, so the edge at a yolo layer is that conv's output
    head_scales = []
    for i, lyr in enumerate(layers):
        if lyr.kind == 'yolo':
            hc = layers[i - 1] if i else None
            if hc is None or hc.kind != 'conv':
                raise unported(f'yolo layer {i} that does not directly '
                               'follow its head conv, in the int8 engine')
            head_scales.append(meta[str(hc.index)]['sa'])

    yolos = [l for l in layers if l.kind == 'yolo']
    anchor_cache: dict = {}

    def apply(arrays, x):
        outs: dict[int, Any] = {}
        yolo_p, head_out, obj_out = [], [], []
        prev = ('f', x)
        for lyr in layers:
            k = str(lyr.index)
            kind = lyr.kind
            if kind == 'conv':
                prev = conv_i8(lyr, arrays[k], prev)
            elif kind == 'maxpool':
                prev = (prev[0], conv_ops.max_pool_nhwc(prev[1], lyr.size,
                                                        lyr.stride), *prev[2:])
            elif kind == 'upsample':
                prev = (prev[0], conv_ops.upsample_nearest_nhwc(
                    prev[1], lyr.stride), *prev[2:])
            elif kind == 'route':
                if len(lyr.layers) > 1:     # requantized concat
                    rs = meta[k]['rs']
                    parts = [requant_edge(outs[j], rs)[1] for j in lyr.layers]
                    prev = ('q', torch.cat(parts, -1), rs)
                elif lyr.route_groups:
                    c = prev[1].shape[-1]
                    prev = (prev[0], prev[1][..., c // 2:].contiguous(),
                            *prev[2:])
                else:
                    prev = outs[lyr.layers[0]]
            elif kind == 'shortcut':
                prev = shortcut_i8(lyr, arrays.get(k), prev, outs)
            elif kind == 'reorg3d':     # pure layout: scale unchanged
                prev = (prev[0], conv_ops.space_to_depth_nhwc(
                    prev[1], lyr.stride), *prev[2:])
            elif kind == 'yolo':
                if heads_only:
                    # the head stays int8; the obj map is its dequantized
                    # obj channel (head convs are linear: that is the logit)
                    head_out.append(prev[1])
                    obj_out.append(prev[1][..., 4::lyr.no].to(torch.float32)
                                   * prev[2])
                else:
                    hf = _as_float(prev)
                    yolo_p.append(reshape_pred(hf, lyr.na, lyr.no))
                    head_out.append(hf)
            # dropout: identity
            if lyr.is_routed:
                outs[lyr.index] = prev

        if heads_only:
            return head_out, obj_out
        anchors = anchors_on(yolos, anchor_cache, head_out[0].device)
        io = torch.cat([decode_yolo_nhwc(h, a, l.yolo_stride, l.no)
                        for h, a, l in zip(head_out, anchors, yolos)], 1)
        return io, yolo_p

    apply.head_scales = tuple(head_scales)
    return apply
