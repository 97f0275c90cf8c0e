"""True-int8 inference engine (counterpart of yolo_tpu/models/int8_engine.py).

The fake-quant sim (``compress/quant.py``) simulates integer arithmetic in
float. This engine runs the calibrated model with int8 tensors end to end:

  - conv weights are pre-quantized to int8 (BN folded, pow-2 scale) and
    stored (Cout, K, K, Cin / groups), the order kernel K2 reads them in;
  - activations travel between layers as int8 NHWC tensors with a per-edge
    pow-2 scale;
  - every ungrouped 1x1 s1 and 3x3 s1/s2 conv on an int8 edge runs K2
    (``ops/conv_int8.fused_conv_int8``: s8 x s8 -> s32 and a fused f32
    epilogue of scale, bias, activation and requantization to the layer's
    own output scale), the arithmetic the sim models; the other convs on
    int8 edges (depthwise and grouped ones, 5x5 windows) run
    ``grouped_conv_int8``, the same arithmetic with exact sums (the JAX
    package runs them through XLA's s8 conv): on the card a depthwise conv
    (groups == Cin == Cout) of a square 1, 3, 5 or 7 window at strides 1
    or 2, which every grouped conv of the cfgs is, runs K4
    (``ops/depthwise_int8.fused_depthwise_int8``: the conv and the
    epilogue in one launch); the rest, and every conv on the CPU, run
    plain PyTorch;
  - shortcuts and concats follow the sim's requantization chains (min/max
    shortcut ways, a common concat scale); a shortcut of one ``from`` layer
    without fusion weights on two int8 edges runs K3
    (``ops/shortcut_int8.fused_shortcut_int8``: the chain in one pass), the
    others the chain in f32 PyTorch;
  - SE, global avgpool, scale_channels and a standalone [batchnorm] (on
    its running statistics) are float edges, as in the sim.

A conv on a float edge (the network input, or the output of an SE,
avgpool, scale_channels or [batchnorm] layer) runs on the bf16-rounded input and the
dequantized int8 weights, summed in f32 (cuDNN on the card), then
requantizes (``ops/conv_int8.float_edge_conv``). Scales are read from a
calibrated qstate when the plan is prepared and baked in as Python floats.

The JAX package's TPU backend menu ('mixed'/'auto') is not carried over:
every int8 conv that K2 takes goes through it, which is the JAX
``backend='pallas'`` routing with ``pallas_min_hw=0`` (its oracle is
``backend='xla'``).

Schemes: google and ptq_cos share the tracker layout (scales in qstate).
TPSQ reads each conv's scales from its ``w_scale``/``b_scale``/``a_scale``
params (``search_pow2``'s value), and its grid is asymmetric: it quantizes
by p2 / qmax, saturating at ±qmax, and dequantizes by p2 / (qmax + 1). Its
edges carry the dequant scale, so every requant multiplies by
``rq_fac / scale`` with ``rq_fac`` = qmax / (qmax + 1) and clips to
[-qmax, qmax]; K2 takes that multiplier as its ``out_mult`` (the JAX
package runs TPSQ's convs through XLA, not Pallas). TPSQ's shortcuts and
concats stay float, as in its sim.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..compress.quant import (QuantConfig, check_supported, qrange,
                              unported)
from ..ir import NetworkIR
from ..ops import conv as conv_ops
from ..ops.conv import LONE_BN_EPS
from ..ops.conv_int8 import (float_edge_conv, fused_conv_int8,
                              grouped_conv_int8, k2_rows, supported)
from ..ops.int8_math import round_half_away
from ..ops.shortcut_int8 import (fused_shortcut_int8, shortcut_codes,
                                 shortcut_requant)
from ..parallel.collectives import all_gather_dim
from ..utils.profiler import span
from .yolo_head import anchors_on, decode_yolo_nhwc, reshape_pred

BN_EPS = 1e-5
#: the schemes the engine serves
ENGINE_SCHEMES = ('google', 'ptq_cos', 'tpsq')


class Int8Plan(NamedTuple):
    arrays: dict            # {layer_key: {'w8': int8 (Cout,K,K,Cin/groups),
                            #  'bias': f32} | {'fc1', 'fc2'} (SE) | {'w'}}
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


def _tpsq_p2(v) -> float:
    """The value of ``search_pow2``: clip to [2^-5, 2^13], snap to the
    nearest power of two by linear distance (in float64)."""
    v = float(np.clip(_np64(v), 2.0 ** -5, 2.0 ** 13))
    lo, hi = 2.0 ** np.floor(np.log2(v)), 2.0 ** np.ceil(np.log2(v))
    return hi if abs(hi - v) < abs(lo - v) else lo


def check_engine_scheme(scheme: str):
    if scheme not in ENGINE_SCHEMES:
        raise ValueError(f'the int8 engine serves the {ENGINE_SCHEMES} '
                         f'schemes, not {scheme!r}')


def prepare_int8(net: NetworkIR, params, state, qstate, cfg: QuantConfig,
                 device=None) -> Int8Plan:
    """Fold BN, quantize weights/biases to integers, extract frozen scales.

    The eval path of the sim, in float64 numpy as in the JAX package:
    w_fold = w * gamma/sqrt(var+eps), bias = beta - mean*inv (+ b*inv),
    both quantized with their scales (the tracker ones of google and
    ptq_cos; TPSQ's from its params, on its asymmetric grid); the plan
    holds the int8 weights and the dequantized f32 bias the epilogue adds,
    and the SE layers' f32 fc weights, on ``device`` (default: that of the
    params)."""
    check_supported(net, cfg.scheme)
    check_engine_scheme(cfg.scheme)
    tpsq = cfg.scheme == 'tpsq'
    if device is None:
        device = next(iter(next(iter(params.values())).values())).device
    arrays: dict[str, dict] = {}
    meta: dict[str, dict] = {}
    for lyr in net.layers:
        k = str(lyr.index)
        if lyr.kind in ('conv', 'depthwise'):
            p = {f: _np64(v) for f, v in params[k].items()}
            if lyr.bn:
                inv = p['gamma'] / np.sqrt(_np64(state[k]['var']) + BN_EPS)
                w_fold = p['w'] * inv[:, None, None, None]         # OIHW
                bias = p['beta'] + (p.get('b', 0.0) - _np64(state[k]['mean'])) * inv
            else:
                w_fold = p['w']
                bias = p.get('b', np.zeros(lyr.filters))
            if tpsq:
                # weight and bias grids from w_bits, the activation's from
                # a_bits; clamp to ±p2 then scale by qr_q / p2 is scale then
                # saturate at ±qr_q
                qr_q = (1 << (cfg.w_bits - 1)) - 1
                qr_dq = 1 << (cfg.w_bits - 1)
                p2w, p2b, p2a = (_tpsq_p2(params[k][f]) for f in
                                 ('w_scale', 'b_scale', 'a_scale'))
                w8 = np.clip(_q_arr(w_fold, p2w / qr_q, cfg.w_bits),
                             -qr_q, qr_q)
                b8 = np.clip(_q_arr(bias, p2b / qr_q, cfg.w_bits),
                             -qr_q, qr_q)
                bias_dq = b8.astype(np.float32) * np.float32(p2b / qr_dq)
                sw, sa = p2w / qr_dq, p2a / (1 << (cfg.a_bits - 1))
            else:
                qs = qstate[k]
                sw = _scalar(qs['wq']['scale'])
                sb = _scalar(qs['bq']['scale'])
                sa = _scalar(qs['aq']['scale'])
                w8 = _q_arr(w_fold, sw, cfg.w_bits)
                bias_dq = _q_arr(bias, sb, cfg.w_bits).astype(np.float32) * sb
            w8 = w8.transpose(0, 2, 3, 1)
            arrays[k] = {
                'w8': torch.from_numpy(np.ascontiguousarray(w8)).to(device),
                'bias': torch.from_numpy(
                    np.asarray(bias_dq, np.float32)).to(device)}
            meta[k] = {'sw': sw, 'sa': sa}
        elif lyr.kind == 'shortcut':
            if k in qstate:
                qs = qstate[k]
                meta[k] = {'in_scale': _scalar(qs['input_scale'
                                                  if cfg.shortcut_way == 1
                                                  else 'scale']),
                           'sc': _scalar(qs['scale'])}
            if lyr.weighted:
                arrays[k] = {'w': params[k]['w'].detach().to(
                    device, torch.float32)}
        elif lyr.kind == 'route' and len(lyr.layers) > 1 and k in qstate:
            meta[k] = {'rs': _scalar(qstate[k]['scale'])}
        elif lyr.kind == 'se':
            arrays[k] = {f: params[k][f].detach().to(device, torch.float32)
                         for f in ('fc1', 'fc2')}
        elif lyr.kind == 'batchnorm':
            arrays[k] = {f: t.detach().to(device, torch.float32)
                         for f, t in (*params[k].items(), *state[k].items())}
    return Int8Plan(arrays=arrays, meta=meta, a_bits=cfg.a_bits,
                    shortcut_way=cfg.shortcut_way,
                    maxabsscaler=cfg.maxabsscaler, scheme=cfg.scheme)


# a carried edge: ('q', int8 NHWC tensor, scale) | ('f', f32 NHWC tensor)

def _as_float(t):
    if t[0] == 'f':
        return t[1].to(torch.float32)
    return t[1].to(torch.float32) * t[2]


def make_int8_apply(net: NetworkIR, plan: Int8Plan, heads_only: bool = False,
                    conv=fused_conv_int8, spatial=None):
    """Build apply(arrays, x) -> (io, yolo_p) on an NHWC f32 batch x.
    Inference only.

    ``heads_only``: return (head_out, obj_out) instead: the int8 NHWC head
    tensors (``apply.head_scales`` holds their per-scale dequant factors)
    and per-scale objectness-logit maps (the strided obj-channel slice of
    the int8 head, dequantized) for the sparse NMS
    (``ops/nms.non_max_suppression_heads(..., head_scales=...)``), which
    dequantizes only the rows it gathers.

    ``conv``: the int8 conv of the convs K2 takes, K2 (``fused_conv_int8``)
    by default; pass its plain version (``fused_conv_int8_reference``) to
    hold one against the other on the card.

    ``spatial`` (spatial partitioning): the process group over whose ranks
    the image's rows are split; ``x`` holds this rank's rows
    (``parallel.shard_spatial``). Each conv takes its halo rows from the
    neighbours (int8 rows on an int8 edge; K2 on its stride-aligned block,
    ``ops/conv_int8.k2_rows``), the pools follow ``ops/conv``'s row rules,
    SE and avgpool sum over the group, and the head maps (int8) are
    gathered whole before the obj maps and the decode, whose grid offsets
    are the whole image's rows: every rank returns one process's
    outputs.

    Spans (``utils/profiler.py``): each conv runs in ``engine.conv``, and
    inside it a conv that ``grouped_conv_int8`` runs in ``engine.grouped``,
    one that ``float_edge_conv`` runs in ``engine.float_conv``; each
    shortcut runs in ``engine.shortcut``, each multi-route concat in
    ``engine.concat``, each SE, global avgpool and scale_channels layer in
    ``engine.se``."""
    check_supported(net, plan.scheme)
    check_engine_scheme(plan.scheme)
    layers = net.layers
    bits = plan.a_bits
    qmin, qmax = qrange(bits, True)
    meta = plan.meta
    tpsq = plan.scheme == 'tpsq'
    # TPSQ's edges carry the dequant scale p2 / (qmax + 1) and quantize by
    # p2 / qmax: the requant multiplier is rq_fac / scale
    rq_fac = qmax / (qmax + 1.0) if tpsq else 1.0
    rq_min = -qmax if tpsq else qmin

    def mult(scale):
        """The requant multiplier to ``scale``: the double quotient, which
        the epilogue rounds once to f32 (exact pow-2 inverses for google and
        ptq_cos)."""
        return rq_fac / scale

    def requant_edge(t, scale):
        """Requantize a carried edge to ``scale`` (saturating)."""
        if t[0] == 'q' and t[2] == scale:
            return t
        y = round_half_away(_as_float(t) * mult(scale))
        return ('q', torch.clamp(y, rq_min, qmax).to(torch.int8), scale)

    def conv_i8(lyr, arr, t, sp):
        stride = lyr.stride_xy or lyr.stride
        m = meta[str(lyr.index)]
        epi = dict(act=lyr.activation, maxabs=plan.maxabsscaler, qmin=rq_min,
                   qmax=qmax, out_mult=mult(m['sa']) if tpsq else None)
        if t[0] == 'f':
            x, pad = conv_ops.conv_rows_nhwc(t[1], lyr.size, stride, lyr.pad,
                                             sp)
            with span('engine.float_conv'):
                q = float_edge_conv(x, arr['w8'], arr['bias'], m['sw'],
                                    m['sa'], stride=stride, pad=pad,
                                    groups=lyr.groups, **epi)
        elif (isinstance(stride, int)
              and supported(lyr.size, stride, lyr.pad, lyr.groups)):
            args = (t[1], arr['w8'], arr['bias'], t[2] * m['sw'], m['sa'])
            q = (conv(*args, stride=stride, out_q=True, **epi) if sp is None
                 else k2_rows(*args, stride=stride, group=sp, conv=conv,
                              out_q=True, **epi))
        else:
            x, pad = conv_ops.conv_rows_nhwc(t[1], lyr.size, stride, lyr.pad,
                                             sp)
            with span('engine.grouped'):
                q = grouped_conv_int8(x, arr['w8'], arr['bias'],
                                      t[2] * m['sw'], m['sa'], stride=stride,
                                      pad=pad, groups=lyr.groups, **epi)
        return ('q', q, m['sa'])

    def shortcut_f(lyr, arr, t, outs):
        """The float shortcut of a scheme without requantization (TPSQ):
        the weighted sum and channel slicing of the float network."""
        ws = None
        x = _as_float(t)
        if lyr.weighted:
            ws = torch.sigmoid(arr['w']) * (2.0 / (len(lyr.layers) + 1))
            x = x * ws[0]
        for i, j in enumerate(lyr.layers):
            a = _as_float(outs[j])
            if ws is not None:
                a = a * ws[i + 1]
            nx_, na_ = x.shape[-1], a.shape[-1]
            if nx_ == na_:
                x = x + a
            elif nx_ > na_:
                x = torch.cat([x[..., :na_] + a, x[..., na_:]], -1)
            else:
                x = x + a[..., :nx_]
        return ('f', x)

    def shortcut_i8(lyr, arr, t, outs):
        """A requantized shortcut: K3 (``fused_shortcut_int8``; its plain
        twin on the CPU) where it has one ``from`` layer, no fusion weights
        and two int8 edges, else the sim's requantization chain in f32 (the
        same steps; scales are pow-2, so the inverses are exact and every
        fake-quant is a multiply)."""
        if str(lyr.index) not in meta:
            return shortcut_f(lyr, arr, t, outs)
        m = meta[str(lyr.index)]
        kw = dict(way=plan.shortcut_way, qmin=qmin, qmax=qmax)
        if (not lyr.weighted and len(lyr.layers) == 1 and t[0] == 'q'
                and outs[lyr.layers[0]][0] == 'q'):
            e = outs[lyr.layers[0]]
            q = fused_shortcut_int8(t[1].contiguous(), t[2],
                                    e[1].contiguous(), e[2], m['in_scale'],
                                    m['sc'], **kw)
            return ('q', q, m['sc'])
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
            x = shortcut_requant(x, a, m['in_scale'], m['sc'], **kw)
        return ('q', shortcut_codes(x, m['sc'], qmin=qmin, qmax=qmax),
                m['sc'])

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
        rows = conv_ops.RowSplit(spatial)
        for lyr in layers:
            k = str(lyr.index)
            kind = lyr.kind
            sp = rows.split
            if kind in ('conv', 'depthwise'):
                with span('engine.conv'):
                    prev = conv_i8(lyr, arrays[k], prev, sp)
            elif kind in ('se', 'avgpool', 'scale_channels'):
                with span('engine.se'):
                    if kind == 'se':
                        y = conv_ops.se_block_nhwc(
                            _as_float(prev), arrays[k]['fc1'],
                            arrays[k]['fc2'], group=sp)
                    elif kind == 'avgpool':
                        y = conv_ops.global_avg_pool_nhwc(_as_float(prev),
                                                          group=sp)
                    else:
                        y = _as_float(outs[lyr.layers[0]]) * _as_float(prev)
                    prev = ('f', y)
            elif kind == 'batchnorm':   # a float edge (eps 1e-4)
                a = arrays[k]
                prev = ('f', conv_ops.batch_norm_infer(
                    _as_float(prev).permute(0, 3, 1, 2), a['gamma'],
                    a['beta'], a['mean'], a['var'],
                    LONE_BN_EPS).permute(0, 2, 3, 1))
            elif kind == 'maxpool':
                prev = (prev[0], conv_ops.max_pool_nhwc(
                    prev[1], lyr.size, lyr.stride, group=sp), *prev[2:])
            elif kind == 'upsample':
                prev = (prev[0], conv_ops.upsample_nearest_nhwc(
                    prev[1], lyr.stride), *prev[2:])
            elif kind == 'route':
                if len(lyr.layers) > 1 and k in meta:   # requantized concat
                    rs = meta[k]['rs']
                    with span('engine.concat'):
                        parts = [requant_edge(outs[j], rs)[1]
                                 for j in lyr.layers]
                        prev = ('q', torch.cat(parts, -1), rs)
                elif len(lyr.layers) > 1:       # float concat (TPSQ)
                    with span('engine.concat'):
                        prev = ('f', torch.cat([_as_float(outs[j])
                                                for j in lyr.layers], -1))
                elif lyr.route_groups:
                    c = prev[1].shape[-1]
                    prev = (prev[0], prev[1][..., c // 2:].contiguous(),
                            *prev[2:])
                else:
                    prev = outs[lyr.layers[0]]
            elif kind == 'shortcut':
                with span('engine.shortcut'):
                    prev = shortcut_i8(lyr, arrays.get(k), prev, outs)
            elif kind == 'reorg3d':     # pure layout: scale unchanged
                prev = (prev[0], conv_ops.space_to_depth_nhwc(
                    prev[1], lyr.stride), *prev[2:])
            elif kind == 'yolo':
                h = prev if sp is None else (
                    prev[0], all_gather_dim(prev[1], 1, sp), *prev[2:])
                if heads_only:
                    # the head stays int8; the obj map is its dequantized
                    # obj channel (head convs are linear: that is the logit)
                    head_out.append(h[1])
                    obj_out.append(h[1][..., 4::lyr.no].to(torch.float32)
                                   * h[2])
                else:
                    hf = _as_float(h)
                    yolo_p.append(reshape_pred(hf, lyr.na, lyr.no))
                    head_out.append(hf)
            # dropout: identity
            rows.after(lyr)
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
