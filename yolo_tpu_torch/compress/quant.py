"""Fake-quant simulation of the google scheme, forward only (counterpart of
``yolo_tpu/compress/quant.py``).

What this slice needs for true-int8 serving: the quantizer math, the
range trackers, the BN-fold quantized conv, the requantized shortcut
(ways 1 and 2) and concat, and ``make_quant_apply`` in train mode (the
calibration step: it returns the new BN state and quantizer state) and
in eval mode (the sim the int8 engine is held against).

Quantizer state lives in an explicit ``qstate`` dict of 0-d f32 tensors
(scale, zero point, tracker min/max, step counters), keyed by layer-index
strings as in the JAX package. Every function returns a new state and
mutates none. Activations are NHWC, as in the JAX package; conv weights
are the port's OIHW. All quantized scales snap to powers of two.

Not ported yet (see ROADMAP.md): the other schemes (tpsq, ptq_cos, dorefa,
wbin, ternary), the straight-through gradient as an autograd Function
(QAT training), ``prepare_eval_params`` and the bf16 eval snaps.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ir import NetworkIR
from ..models.yolo_head import anchors_on, decode_yolo_nhwc, reshape_pred
from ..ops import activations as act_mod
from ..ops import conv as conv_ops
from ..ops.conv_int8 import round_half_away

BN_EPS = 1e-5
BN_MOMENTUM = 0.01     # quantized-conv BN momentum
EMA_MOMENTUM = 0.1     # activation range tracker momentum

SCHEMES = {1: 'google', 2: 'tpsq', 3: 'ptq_cos', 4: 'dorefa', 5: 'wbin',
           6: 'ternary'}
# layer kinds the sim and the int8 engine run; the rest raise
# NotImplementedError
QUANT_KINDS = ('conv', 'maxpool', 'route', 'shortcut', 'upsample', 'yolo',
               'reorg3d', 'dropout')


def unported(what: str):
    return NotImplementedError(f'{what} is not ported to yolo_tpu_torch yet '
                               '(see ROADMAP.md)')


# --------------------------------------------------------------------------
# primitive quantizer math
# --------------------------------------------------------------------------

def pow2_snap(x):
    """Snap to the nearest power of two by linear distance; a tie goes to
    the lower power."""
    x = torch.clamp_min(x, 1e-38)
    lg = torch.log2(x)
    lo = torch.exp2(torch.floor(lg))
    hi = torch.exp2(torch.ceil(lg))
    return torch.where(torch.abs(hi - x) < torch.abs(lo - x), hi, lo)


def qrange(bits: int, sign: bool = True):
    if sign:
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


def fq(x, scale, zero_point, bits: int, sign: bool = True):
    """Fake quantize: quantize, round half away, clamp, dequantize; the
    arithmetic runs in f32 and the result keeps x's dtype.

    The result is written ``x + (dq - x)``, the JAX package's
    straight-through form, so that it is the same float as there: where
    the clamp moves x by more than a factor of two that sum is not
    bit-equal to ``dq``."""
    qmin, qmax = qrange(bits, sign)
    xf = x.to(torch.float32)
    q = torch.clamp(round_half_away(xf / scale + zero_point), qmin, qmax)
    dq = ((q - zero_point) * scale).to(x.dtype)
    return x + (dq - x).detach()


# --------------------------------------------------------------------------
# tracker-based quantizer (google scheme)
# --------------------------------------------------------------------------

def tracker_init(device=None):
    z = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return {'min': z(0.0), 'max': z(0.0), 'first': z(0.0), 'scale': z(1.0),
            'zp': z(0.0), 'step': z(0.0)}


def _update_range(qs, x, track: str):
    mn, mx = torch.min(x), torch.max(x)
    first = qs['first'] == 0
    if track == 'ema':     # averaged range tracker
        new_min = torch.where(first, mn, qs['min'] * (1 - EMA_MOMENTUM)
                              + mn * EMA_MOMENTUM)
        new_max = torch.where(first, mx, qs['max'] * (1 - EMA_MOMENTUM)
                              + mx * EMA_MOMENTUM)
    else:
        # 'global': NOT a min/max envelope. The reference tracker aliases
        # its temporary to the live buffer, so after the first batch the
        # range is the CURRENT batch's range clamped through zero. Mirrored
        # exactly (weight scales must match).
        zero = torch.zeros_like(mn)
        new_min = torch.where(first, mn, torch.minimum(zero, mn))
        new_max = torch.where(first, mx, torch.maximum(zero, mx))
    return {**qs, 'min': new_min, 'max': new_max,
            'first': torch.ones_like(qs['first'])}


def _update_scale(qs, bits: int, sym: bool, sign: bool):
    qmin, qmax = qrange(bits, sign)
    quantized_range = max(abs(qmin), abs(qmax)) if sym else (qmax - qmin)
    if sym:
        float_max = torch.maximum(torch.abs(qs['min']), torch.abs(qs['max']))
        scale = pow2_snap(float_max) / quantized_range
        zp = torch.zeros_like(scale)
    else:
        scale = pow2_snap(qs['max'] - qs['min']) / quantized_range
        zp = round_half_away(qmax - qs['max'] / scale)
    return {**qs, 'scale': scale, 'zp': zp}


def google_quantize(x, qs, *, bits: int, train: bool, freeze_step: float,
                    sym: bool = True, sign: bool = True, track: str = 'ema'):
    """One tracker-quantizer application. In train mode the range and scale
    update while ``step < freeze_step``, and ``step`` counts up. Returns
    (y, qs')."""
    if bits == 32:
        return x, qs
    if train:
        do_update = qs['step'] < freeze_step
        updated = _update_scale(_update_range(qs, x.detach(), track), bits,
                                sym, sign)
        qs = {k: torch.where(do_update, updated[k], v) for k, v in qs.items()}
        qs['step'] = qs['step'] + 1
    return fq(x, qs['scale'], qs['zp'], bits, sign), qs


# --------------------------------------------------------------------------
# quantized network
# --------------------------------------------------------------------------

class QuantConfig(NamedTuple):
    scheme: str = 'google'        # only 'google' is ported
    a_bits: int = 8
    w_bits: int = 8
    shortcut_way: int = 1          # 1 = min-range, 2 = max-range requant
    maxabsscaler: bool = False
    steps: int = 0                 # total calibration/train steps

    @property
    def bn_freeze_step(self) -> int:
        return int(self.steps * 0.9)

    @property
    def scale_freeze_step(self) -> int:
        return int(self.steps * 0.1)


def check_supported(net: NetworkIR, scheme: str):
    """Raise NotImplementedError naming the first scheme or layer kind that
    the sim and the int8 engine lack."""
    if scheme != 'google':
        raise unported(f'quantization scheme {scheme!r}')
    for lyr in net.layers:
        if lyr.kind not in QUANT_KINDS:
            raise unported(f'layer {lyr.index}: kind {lyr.kind!r} in a '
                           'quantized model')
        if lyr.kind == 'yolo' and len(lyr.layers) >= 2:
            raise unported('ASFF yolo heads')


def init_quant_state(net: NetworkIR, cfg: QuantConfig, device=None):
    """The qstate dict (and the extra trainable params, none for the google
    scheme): a tracker triple and step counters per conv, trackers and
    scales per shortcut, a per-source |max| list and a scale per concat."""
    check_supported(net, cfg.scheme)
    z = lambda v, n=None: (torch.full((n,), v, dtype=torch.float32,
                                      device=device) if n is not None else
                           torch.tensor(v, dtype=torch.float32, device=device))
    qstate: dict[str, Any] = {}
    for lyr in net.layers:
        k = str(lyr.index)
        if lyr.kind == 'conv':
            qstate[k] = {'aq': tracker_init(device), 'wq': tracker_init(device),
                         'bq': tracker_init(device), 'first_bn': z(0.0),
                         'step': z(0.0)}
        elif lyr.kind == 'shortcut':
            qstate[k] = {'x': tracker_init(device), 'a': tracker_init(device),
                         'sum': tracker_init(device), 'scale': z(1.0),
                         'input_scale': z(1.0)}
        elif lyr.kind == 'route' and len(lyr.layers) > 1:
            qstate[k] = {'float_max': z(0.0, len(lyr.layers)),
                         'scale': z(1.0)}
    return qstate, {}


def _bn_fold(p, st, qs, out_f, train: bool, cfg: QuantConfig):
    """Two-phase BN fold: batch statistics before ``bn_freeze_step``,
    running ones after; running stats are an EMA of momentum 0.01 whose
    first batch is copied in while they are still all zero (stats loaded
    from a checkpoint are never overwritten). Returns (w_fold_scale,
    bias_fold, new_st, new_qs)."""
    gamma, beta = p['gamma'], p['beta']
    if train:
        out32 = out_f.to(torch.float32)                      # NHWC
        n = out32.shape[0] * out32.shape[1] * out32.shape[2]
        batch_mean = out32.mean((0, 1, 2))
        bv = out32.var((0, 1, 2), unbiased=False) * n / max(n - 1, 1)
        first = ((qs['first_bn'] == 0) & torch.all(st['mean'] == 0)
                 & torch.all(st['var'] == 0))
        new_mean = torch.where(first, batch_mean, st['mean'] * (1 - BN_MOMENTUM)
                               + batch_mean * BN_MOMENTUM)
        new_var = torch.where(first, bv, st['var'] * (1 - BN_MOMENTUM)
                              + bv * BN_MOMENTUM)
        use_batch = qs['step'] < cfg.bn_freeze_step
        mean_sel = torch.where(use_batch, batch_mean, new_mean)
        var_sel = torch.where(use_batch, bv, new_var)
        new_st = {'mean': new_mean.detach(), 'var': new_var.detach()}
        new_qs = {**qs, 'first_bn': torch.where(
            first, torch.ones_like(qs['first_bn']), qs['first_bn'])}
    else:
        mean_sel, var_sel = st['mean'], st['var']
        new_st, new_qs = st, qs
    inv = gamma / torch.sqrt(var_sel + BN_EPS)
    if 'b' in p:
        bias = beta + (p['b'] - mean_sel) * inv
    else:
        bias = beta - mean_sel * inv
    return inv, bias, new_st, new_qs


def _fold_quant_weights(cfg, lyr, p, st, qs, *, train, x=None):
    """BN fold + google weight/bias fake-quant of one conv. Returns
    (qw OIHW, qb, st, qs); trackers and stats update only when ``train``
    (the stat conv of the batch statistics runs on ``x`` then)."""
    if lyr.bn:
        out_f = (conv_ops.conv2d_nhwc(x, p['w'],
                                      stride=lyr.stride_xy or lyr.stride,
                                      padding=lyr.pad, groups=lyr.groups)
                 if train else None)
        inv, bias, st, qs = _bn_fold(p, st, qs, out_f, train, cfg)
        w_fold = p['w'] * inv[:, None, None, None]
    else:
        w_fold = p['w']
        bias = p['b'] if 'b' in p else torch.zeros(
            lyr.filters, dtype=torch.float32, device=p['w'].device)
    qs = dict(qs)
    qw, qs['wq'] = google_quantize(w_fold, qs['wq'], bits=cfg.w_bits,
                                   train=train,
                                   freeze_step=cfg.scale_freeze_step,
                                   track='global')
    qb, qs['bq'] = google_quantize(bias, qs['bq'], bits=cfg.w_bits,
                                   train=train,
                                   freeze_step=cfg.scale_freeze_step,
                                   track='global')
    return qw, qb, st, qs


def _add_sliced(x, a):
    """Darknet shortcut add with channel mismatch: add into the leading
    channels, or slice the added map."""
    nx_, na_ = x.shape[-1], a.shape[-1]
    if nx_ == na_:
        return x + a
    if nx_ > na_:
        return torch.cat([x[..., :na_] + a, x[..., na_:]], -1)
    return x + a[..., :nx_]


def make_quant_apply(net: NetworkIR, cfg: QuantConfig,
                     heads_only: bool = False):
    """Build the google-scheme fake-quant apply on NHWC f32 inputs:

    apply(params, state, qstate, x, train=False) ->
      train: ((yolo_p, feats), new_state, new_qstate)
      eval:  (io, yolo_p, feats), or (head_out, [None] * n) with
             ``heads_only``

    conv -> BN-fold quantized conv with a quantized activation; shortcut ->
    requantized add (min or max way); multi-route -> requantized concat.
    Train mode is calibration: range trackers, scales and BN statistics
    update; nothing is differentiated here."""
    check_supported(net, cfg.scheme)
    layers = net.layers
    bits = cfg.a_bits
    qmin, qmax = qrange(bits, True)
    qr = max(abs(qmin), abs(qmax))

    def qconv(lyr, p, st, qs, x, train):
        qw, qb, st, qs = _fold_quant_weights(cfg, lyr, p, st, qs, train=train,
                                             x=x)
        out = conv_ops.conv2d_nhwc(x, qw, stride=lyr.stride_xy or lyr.stride,
                                   padding=lyr.pad, groups=lyr.groups)
        out = act_mod.get(lyr.activation, cfg.maxabsscaler)(out + qb)
        out, qs['aq'] = google_quantize(out, qs['aq'], bits=bits, train=train,
                                        freeze_step=cfg.scale_freeze_step,
                                        track='ema')
        qs['step'] = qs['step'] + 1
        return out, st, qs

    def qshortcut(lyr, params, qs, x, outs, train):
        """Requantized residual add: way 1 (min range) shares an input
        scale and tracks the QUANTIZED sum; way 2 (max range) tracks the
        float sum up front and uses one scale for x, a and the sum."""
        w = None
        if lyr.weighted:
            w = (torch.sigmoid(params[str(lyr.index)]['w'])
                 * (2.0 / (len(lyr.layers) + 1))).to(x.dtype)
            x = x * w[0]
        for i, j in enumerate(lyr.layers):
            a = outs[j]
            if w is not None:
                a = a * w[i + 1]
            if train:
                qs['x'] = _update_range(qs['x'], x.detach(), 'ema')
                qs['a'] = _update_range(qs['a'], a.detach(), 'ema')
                if cfg.shortcut_way == 2:
                    # the overlapping channels only, not _add_sliced
                    c = min(x.shape[-1], a.shape[-1])
                    s = x[..., :c] + a[..., :c]
                    qs['sum'] = _update_range(qs['sum'], s.detach(), 'ema')
                    fmax = torch.maximum(torch.maximum(qs['sum']['max'],
                                                       qs['x']['max']),
                                         qs['a']['max'])
                    fmin = torch.minimum(torch.minimum(qs['sum']['min'],
                                                       qs['x']['min']),
                                         qs['a']['min'])
                    qs['scale'] = pow2_snap(torch.maximum(
                        torch.abs(fmin), torch.abs(fmax))) / qr
                    qs['input_scale'] = qs['scale']
                else:
                    fmax = torch.minimum(qs['x']['max'], qs['a']['max'])
                    fmin = torch.maximum(qs['x']['min'], qs['a']['min'])
                    qs['input_scale'] = pow2_snap(torch.maximum(
                        torch.abs(fmin), torch.abs(fmax))) / qr
            if cfg.shortcut_way == 2:
                in_scale = qs['scale']
                xq = fq(x, in_scale, 0.0, bits)
                aq = fq(a, in_scale, 0.0, bits)
            else:   # min way: round without clamp
                in_scale = qs['input_scale']
                xq = x + (round_half_away(x / in_scale) * in_scale - x).detach()
                aq = a + (round_half_away(a / in_scale) * in_scale - a).detach()
            s = _add_sliced(xq, aq)
            if train and cfg.shortcut_way == 1:
                qs['sum'] = _update_range(qs['sum'], s.detach(), 'ema')
                qs['scale'] = pow2_snap(torch.maximum(
                    torch.abs(qs['sum']['min']),
                    torch.abs(qs['sum']['max']))) / qr
            x = fq(s, qs['scale'], 0.0, bits)
        return x, qs

    def qconcat(lyr, qs, outs, train):
        """Requantized concat: per-source EMA |max| list, one common pow-2
        scale = snap(max of the list)."""
        parts = [outs[j] for j in lyr.layers]
        if train:
            fmaxs = []
            for i, t in enumerate(parts):
                t = t.detach()
                m = torch.maximum(torch.max(t), torch.abs(torch.min(t)))
                old = qs['float_max'][i]
                fmaxs.append(torch.where(old == 0, m, old * (1 - EMA_MOMENTUM)
                                         + m * EMA_MOMENTUM))
            fl = torch.stack(fmaxs)
            qs = {**qs, 'float_max': fl, 'scale': pow2_snap(torch.max(fl)) / qr}
        parts = [fq(t, qs['scale'], 0.0, bits) for t in parts]
        return torch.cat(parts, -1), qs

    yolos = [l for l in layers if l.kind == 'yolo']
    anchor_cache: dict = {}

    def apply(params, state, qstate, x, train: bool = False):
        outs: dict[int, Any] = {}
        yolo_p, head_out, feats = [], [], []
        new_state = dict(state)
        new_q = {k: dict(v) for k, v in qstate.items()}
        prev = x
        for lyr in layers:
            k = str(lyr.index)
            kind = lyr.kind
            if kind == 'conv':
                st = state.get(k, {})
                prev, st2, new_q[k] = qconv(lyr, params[k], st, new_q[k],
                                            prev, train)
                if st:
                    new_state[k] = st2
            elif kind == 'maxpool':
                prev = conv_ops.max_pool_nhwc(prev, lyr.size, lyr.stride)
            elif kind == 'upsample':
                prev = conv_ops.upsample_nearest_nhwc(prev, lyr.stride)
            elif kind == 'route':
                if len(lyr.layers) > 1:
                    prev, new_q[k] = qconcat(lyr, new_q[k], outs, train)
                elif lyr.route_groups:
                    prev = prev[..., prev.shape[-1] // 2:]
                else:
                    prev = outs[lyr.layers[0]]
            elif kind == 'shortcut':
                prev, new_q[k] = qshortcut(lyr, params, new_q[k], prev, outs,
                                           train)
            elif kind == 'yolo':
                yolo_p.append(reshape_pred(prev, lyr.na, lyr.no))
                head_out.append(prev)
            elif kind == 'reorg3d':
                prev = conv_ops.space_to_depth_nhwc(prev, lyr.stride)
            # dropout: identity
            if lyr.is_routed:
                outs[lyr.index] = prev
            if lyr.feature_out:
                feats.append(prev)

        if train:
            return (yolo_p, feats), new_state, new_q
        if heads_only:
            return head_out, [None] * len(head_out)
        anchors = anchors_on(yolos, anchor_cache, head_out[0].device)
        io = torch.cat([decode_yolo_nhwc(h, a, l.yolo_stride, l.no)
                        for h, a, l in zip(head_out, anchors, yolos)], 1)
        return io, yolo_p, feats

    apply.qcfg = cfg
    return apply
