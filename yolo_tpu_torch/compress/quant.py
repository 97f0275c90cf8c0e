"""Fake-quant simulation and QAT of the six quantization schemes
(counterpart of ``yolo_tpu/compress/quant.py``).

Schemes, by the ``--quantized`` number:
  1 'google'  -- tracker-scaled QAT with the BN fold during training;
  2 'tpsq'    -- trainable pow-2 scales: each conv's ``w_scale``,
                 ``b_scale`` and ``a_scale`` params go through
                 ``search_pow2`` (its own gradient); shortcuts and concats
                 stay float;
  3 'ptq_cos' -- post-training cosine-similarity pow-2 scale search with
                 per-batch votes;
  4 'dorefa', 5 'wbin', 6 'ternary' -- the legacy weight (and, for DoReFa,
                 activation) transforms of ``quant_legacy.py``, stateless,
                 with float shortcuts and concats.

What it holds: the quantizer math, the range trackers, the BN-fold
quantized conv (grouped and depthwise ones included), the requantized
shortcut (ways 1 and 2) and concat, and ``make_quant_apply``. Its train
mode is both the calibration step and the QAT forward: it returns the new
BN state and quantizer state, and autograd differentiates through the BN
fold on batch statistics, its statistics conv and every fake-quant
(straight-through estimators, written ``x + (t - x).detach()``). In a
data-parallel step the train mode takes the data group (``apply(...,
group=...)``): the activation trackers' min/max, the cos-PTQ votes' cosines
and the BN fold's batch statistics are then the global batch's, as under
the JAX package's mesh; weights are replicated and need no collective.
Under tensor parallelism it also takes the model group (``apply(...,
model_group=...)``): a split conv runs its block of the filters and
gathers its activation, and its weight's per-tensor reductions span the
model group (``_fold_quant_weights``). Its eval
mode is the sim the int8 engine is held against. SE, global avgpool,
scale_channels and a standalone [batchnorm] stay float, as in the JAX
package's sim.

Quantizer state lives in an explicit ``qstate`` dict of f32 tensors (scale,
zero point, tracker min/max, votes, step counters), keyed by layer-index
strings as in the JAX package. Every function returns a new state and
mutates none. Activations are NHWC; conv weights are the port's OIHW. All
quantized scales snap to powers of two.

Where a value is differentiated at a kink, the port takes JAX's derivative
(on the quantization grids values sit on kinks often): ``|x|`` has slope 1
at 0 (``_abs``), leaky ReLU slope 1 at 0 and a clip 0.5 at either edge
(``_activation``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ir import NetworkIR
from ..models.yolo_head import anchors_on, decode_yolo_nhwc, reshape_pred
from ..ops import activations as act_mod
from ..ops import conv as conv_ops
from ..ops.conv import LONE_BN_EPS, LONE_BN_MOM
from ..ops.int8_math import round_half_away
from ..parallel.collectives import (all_gather_dim, all_reduce_nograd,
                                    batch_moments, copy_to_model,
                                    gather_channels)
from ..parallel.mesh import split_group

BN_EPS = 1e-5
BN_MOMENTUM = 0.01     # quantized-conv BN momentum
EMA_MOMENTUM = 0.1     # activation range tracker momentum

SCHEMES = {1: 'google', 2: 'tpsq', 3: 'ptq_cos', 4: 'dorefa', 5: 'wbin',
           6: 'ternary'}
#: schemes whose shortcuts and concats requantize (qstate entries); the
#: others keep them float
REQUANT_SCHEMES = ('google', 'ptq_cos')
# layer kinds the sim and the int8 engine run; the rest raise
# NotImplementedError
QUANT_KINDS = ('conv', 'depthwise', 'batchnorm', 'maxpool', 'se', 'avgpool',
               'scale_channels', 'route', 'shortcut', 'upsample', 'yolo',
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


def fq(x, scale, zero_point, bits: int, sign: bool = True, snap_dtype=None):
    """Fake quantize: quantize, round half away, clamp, dequantize; the
    arithmetic runs in f32 and the result keeps x's dtype.

    The result is written ``x + (dq - x)``, the JAX package's
    straight-through form, so that it is the same float as there: where
    the clamp moves x by more than a factor of two that sum is not
    bit-equal to ``dq``.

    ``snap_dtype`` (eval only): the whole chain runs in that dtype, the
    scale and zero point cast to it too, and ``dq`` is returned as it is.
    In bf16 the division by the scale (a power of two over 127) rounds to
    8 mantissa bits first, so a value within ~0.4% of a rounding boundary
    can land one step off the f32 grid; the value stays on the int8 grid."""
    qmin, qmax = qrange(bits, sign)
    dt = snap_dtype or torch.float32
    cast = lambda v: v.to(dt) if torch.is_tensor(v) else v   # host numbers stay
    xf, sc, zp = x.to(dt), cast(scale), cast(zero_point)
    q = torch.clamp(round_half_away(xf / sc + zp), qmin, qmax)
    dq = ((q - zp) * sc).to(x.dtype)
    if snap_dtype is not None:
        return dq
    return x + (dq - x).detach()


def _abs(x):
    """|x| whose derivative at 0 is 1, as JAX's (torch's ``abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _clip(x, lo: float, hi: float):
    """clip(x, lo, hi) whose derivative at either edge is 0.5, as JAX's
    (``torch.clamp`` gives 1)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _leaky(slope):
    # JAX's leaky_relu: slope 1 at 0 (torch's gives ``slope``)
    return lambda x: torch.where(x >= 0, x, x * slope)


_GRAD_ACTS = {
    'relu6': lambda x: _clip(x, 0.0, 6.0),
    'h_swish': lambda x: x * (_clip(x + 3.0, 0.0, 6.0) / 6.0),
    'h_sigmoid': lambda x: _clip(x + 3.0, 0.0, 6.0) / 6.0,
}


def _activation(name: str, maxabs: bool, slope: float | None = None):
    """The activation of a conv; while autograd records, the forms whose
    derivatives at the kinks are JAX's (the values are the same)."""
    if not torch.is_grad_enabled():
        if slope is not None:
            return lambda x: act_mod.leaky(x, slope)
        return act_mod.get(name, maxabs)
    if name == 'leaky':
        return _leaky(slope if slope is not None else 0.25 if maxabs else 0.1)
    return _GRAD_ACTS.get(name) or act_mod.get(name, maxabs)


# --------------------------------------------------------------------------
# tracker-based quantizer (google scheme)
# --------------------------------------------------------------------------

def _scalar(v, device=None):
    return torch.tensor(v, dtype=torch.float32, device=device)


def tracker_init(device=None):
    z = lambda v: _scalar(v, device)
    return {'min': z(0.0), 'max': z(0.0), 'first': z(0.0), 'scale': z(1.0),
            'zp': z(0.0), 'step': z(0.0)}


def _min_max(x, group=None):
    """(min, max) of ``x``, over the ranks of ``group`` too (one MAX
    all-reduce of (-min, max))."""
    mn, mx = torch.min(x), torch.max(x)
    if group is None:
        return mn, mx
    r = all_reduce_nograd(torch.stack([-mn, mx]), group, 'max')
    return -r[0], r[1]


def _update_range(qs, x, track: str, group=None):
    mn, mx = _min_max(x, group)
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
    return {**qs, 'min': new_min.to(torch.float32),
            'max': new_max.to(torch.float32),
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
                    sym: bool = True, sign: bool = True, track: str = 'ema',
                    snap_dtype=None, group=None):
    """One tracker-quantizer application. In train mode the range and scale
    update while ``step < freeze_step`` (the range over the ranks of
    ``group`` too), and ``step`` counts up; eval snaps in ``snap_dtype``
    when given. Returns (y, qs')."""
    if bits == 32:
        return x, qs
    if train:
        do_update = qs['step'] < freeze_step
        updated = _update_scale(_update_range(qs, x.detach(), track, group),
                                bits, sym, sign)
        qs = {k: torch.where(do_update, updated[k], v) for k, v in qs.items()}
        qs['step'] = qs['step'] + 1
    return fq(x, qs['scale'], qs['zp'], bits, sign,
              snap_dtype=None if train else snap_dtype), qs


# --------------------------------------------------------------------------
# TPSQ trainable pow-2 scale
# --------------------------------------------------------------------------

class _SearchPow2(torch.autograd.Function):
    """Forward ``pow2_snap(clip(s, 2^-5, 2^13))``; backward ``g * out / s``
    (``s == 0`` read as 1), no gradient through the clip: the JAX
    package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, s):
        out = pow2_snap(torch.clamp(s, 2.0 ** -5, 2.0 ** 13))
        ctx.save_for_backward(s, out)
        return out

    @staticmethod
    def backward(ctx, g):
        s, out = ctx.saved_tensors
        return g * out / torch.where(s == 0, torch.ones_like(s), s)


def search_pow2(s):
    return _SearchPow2.apply(s)


def tpsq_quantize(x, scale_param, bits: int):
    """TPSQ fake-quant: soft-clamp to ±p2 (p2 = ``search_pow2`` of the
    scale), scale to the integer grid by (2^(b-1) - 1) / p2 and back by
    p2 / 2^(b-1) (the reference's asymmetric quantize and dequantize
    ranges). The quantizer math runs in f32, the output in x's dtype."""
    p2 = search_pow2(scale_param)
    xf = x.to(torch.float32)
    clamped = 0.5 * (_abs(xf + p2) - _abs(xf - p2))
    qr_q = (1 << (bits - 1)) - 1
    qr_dq = 1 << (bits - 1)
    scaled = clamped * qr_q / p2
    q = scaled + (round_half_away(scaled) - scaled).detach()
    return (q * p2 / qr_dq).to(x.dtype)


# the scale searches run their candidates in chunks of at most this many
# elements ((candidates, numel) tensors): few launches for small tensors,
# one candidate at a time for the largest activations
SEARCH_CHUNK = 1 << 24


def _chunks(n_cands: int, numel: int):
    k = max(1, min(n_cands, SEARCH_CHUNK // max(numel, 1)))
    return [slice(i, min(i + k, n_cands)) for i in range(0, n_cands, k)]


def _cosines(dq, xn):
    """Cosine of each row of ``dq`` (k, n) with the unit vector ``xn``."""
    return torch.mv(dq, xn) / torch.clamp_min(
        torch.linalg.vector_norm(dq, dim=1), 1e-12)


def _search_cosines(dq_of, n: int, flat, group=None):
    """The cosine with ``flat`` of each of ``n`` candidates, where
    ``dq_of(c)`` gives the dequantized candidates of the slice ``c`` as
    rows, run in chunks (``SEARCH_CHUNK``). Under ``group``, ``flat`` is
    this rank's part of the vector (a block of a split weight, or of the
    global batch): each candidate's dot product with it and squared norm,
    and its squared norm, are summed over the ranks in one all-reduce."""
    chunks = _chunks(n, flat.numel())
    if group is None:
        xn = flat / torch.clamp_min(torch.linalg.vector_norm(flat), 1e-12)
        return torch.cat([_cosines(dq_of(c), xn) for c in chunks])
    dot, sq = [], []
    for c in chunks:
        dq = dq_of(c)
        dot.append(torch.mv(dq, flat))
        sq.append(dq.square().sum(1))
    g = all_reduce_nograd(torch.cat(dot + sq + [flat.square().sum()[None]]),
                          group)
    return g[:n] / torch.clamp_min(g[n:2 * n].sqrt(), 1e-12) \
        / torch.clamp_min(g[-1].sqrt(), 1e-12)


def _tpsq_search_scale(x, bits: int, group=None):
    """The TPSQ warmup's scale search: 99 candidate scales i * max(x) / 100,
    each quantized through ``tpsq_quantize``; the cosine-similarity winner
    (the first of equal ones). A candidate enters ``tpsq_quantize`` only
    through its power of two, so the cosine is computed once for each
    distinct power (in chunks, ``SEARCH_CHUNK``) and the first candidate of
    the best power wins, as the first of the tied candidates does in the
    JAX package's scan. A tensor with no positive value gives a step of 0
    or less, as there. ``group``: ``x`` is this rank's block of a tensor
    split over it (a split conv's weight or bias), and the maximum, the
    norm and every candidate's dot product and norm are the whole
    tensor's."""
    with torch.no_grad():
        flat = x.detach().reshape(-1).to(torch.float32)
        step = all_reduce_nograd(torch.max(flat), group, 'max') / 100.0
        cands = step * torch.arange(1, 100, dtype=torch.float32,
                                    device=flat.device)
        p2 = search_pow2(cands)
        powers = torch.unique(p2)
        cos = _search_cosines(lambda c: tpsq_quantize(
            flat[None, :], powers[c][:, None], bits), len(powers), flat,
            group)
        first = torch.nonzero(p2 == powers[torch.argmax(cos)])[0, 0]
        return cands[first]


def tpsq_warmup(net, cfg, params, state, qstate, x):
    """Data-driven init of every TPSQ scale param (the reference's
    first-forward warmup): one train-mode forward of ``x`` in which each
    site's scale is its ``_tpsq_search_scale`` winner. Returns a copy of
    ``params`` with ``w_scale``/``b_scale``/``a_scale`` replaced. It runs
    in one process on whole params: the train loop calls it before the
    state is split over a model axis (a train-mode apply under a model
    group with ``warmup`` would search the split weights over the group
    too)."""
    apply = make_quant_apply(net, cfg, warmup=True)
    with torch.no_grad():
        _, _, new_q = apply(params, state, qstate, x, True)
    out = {k: dict(v) for k, v in params.items()}
    for k, q in new_q.items():
        for f in ('w_scale', 'b_scale', 'a_scale'):
            if isinstance(q, dict) and f in q:
                out[k][f] = q[f].to(torch.float32)
    return out


# --------------------------------------------------------------------------
# cos-similarity PTQ scale search
# --------------------------------------------------------------------------

def cospt_init(bits: int, device=None):
    return {'votes': torch.zeros(bits + 7, device=device),
            'scale': _scalar(1.0, device), 'step': _scalar(0.0, device)}


def cospt_quantize(x, qs, *, bits: int, train: bool, group=None):
    """The cos-similarity scale search: candidate float ranges 2^(i-5), i in
    [0, bits + 7); the batch's winner (the first of equal cosines) gets a
    vote and the most-voted candidate is the working scale. The candidates
    run in chunks (``SEARCH_CHUNK``; the JAX package vectorises all of them
    at once), so that a large activation is in memory one copy at a
    time. Under ``group`` the cosines are those of the whole of ``x`` over
    the ranks (``_search_cosines``): the global batch's for an activation
    under the data group, the whole tensor's for a split conv's weight or
    bias under the model group."""
    if bits == 32:
        return x, qs
    qmin, qmax = qrange(bits, True)
    qr = max(abs(qmin), abs(qmax))
    if train:
        with torch.no_grad():
            flat = x.detach().reshape(-1).to(torch.float32)
            n = bits + 7
            scales = torch.exp2(torch.arange(n, dtype=torch.float32,
                                             device=flat.device) - 5.0) / qr
            cos = _search_cosines(lambda c: torch.clamp(round_half_away(
                flat[None, :] / scales[c][:, None]), qmin, qmax)
                * scales[c][:, None], n, flat, group)
            winner = torch.argmax(cos)
            votes = qs['votes'] + (torch.arange(n, device=flat.device)
                                   == winner).to(torch.float32)
            scale = torch.exp2(torch.argmax(votes).to(torch.float32)
                               - 5.0) / qr
        qs = {**qs, 'votes': votes, 'scale': scale, 'step': qs['step'] + 1}
    return fq(x, qs['scale'], 0.0, bits, True), qs


# --------------------------------------------------------------------------
# quantized network
# --------------------------------------------------------------------------

class QuantConfig(NamedTuple):
    scheme: str = 'google'        # google | tpsq | ptq_cos | dorefa | wbin | ternary
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
    """Raise on an unknown scheme (ValueError) or on the first layer kind
    the sim and the int8 engine lack (NotImplementedError)."""
    if scheme not in SCHEMES.values():
        raise ValueError(f'unknown quantization scheme {scheme!r}')
    for lyr in net.layers:
        if lyr.kind not in QUANT_KINDS:
            raise unported(f'layer {lyr.index}: kind {lyr.kind!r} in a '
                           'quantized model')
        if lyr.kind == 'yolo' and len(lyr.layers) >= 2:
            raise unported('ASFF yolo heads')


def init_quant_state(net: NetworkIR, cfg: QuantConfig, device=None):
    """(qstate, extra params), as the JAX package builds them: per conv a
    tracker triple (google) or a cospt triple (ptq_cos) and step counters;
    per shortcut trackers and scales, per concat a per-source |max| list
    and a scale (google and ptq_cos). TPSQ's extra params are each conv's
    trainable ``a_scale``/``w_scale``/``b_scale``, all 1.0."""
    check_supported(net, cfg.scheme)
    z = lambda v: _scalar(v, device)
    sch = cfg.scheme
    qstate: dict[str, Any] = {}
    extra: dict[str, Any] = {}
    for lyr in net.layers:
        k = str(lyr.index)
        if lyr.kind in ('conv', 'depthwise'):
            qs = {'first_bn': z(0.0), 'step': z(0.0)}
            if sch == 'google':
                qs = {'aq': tracker_init(device), 'wq': tracker_init(device),
                      'bq': tracker_init(device), **qs}
            elif sch == 'ptq_cos':
                qs = {'aq': cospt_init(cfg.a_bits, device),
                      'wq': cospt_init(cfg.w_bits, device),
                      'bq': cospt_init(cfg.w_bits, device), **qs}
            elif sch == 'tpsq':
                extra[k] = {'a_scale': z(1.0), 'w_scale': z(1.0),
                            'b_scale': z(1.0)}
            qstate[k] = qs
        elif lyr.kind == 'shortcut' and sch in REQUANT_SCHEMES:
            qstate[k] = {'x': tracker_init(device), 'a': tracker_init(device),
                         'sum': tracker_init(device), 'scale': z(1.0),
                         'input_scale': z(1.0)}
        elif (lyr.kind == 'route' and len(lyr.layers) > 1
              and sch in REQUANT_SCHEMES):
            qstate[k] = {'float_max': torch.zeros(len(lyr.layers),
                                                  device=device),
                         'scale': z(1.0)}
    return qstate, extra


def _bn_fold(p, st, qs, out_f, train: bool, cfg: QuantConfig, group=None):
    """Two-phase BN fold: batch statistics before ``bn_freeze_step``,
    running ones after; running stats are an EMA of momentum 0.01 whose
    first batch is copied in while they are still all zero (stats loaded
    from a checkpoint are never overwritten). The statistics are f32
    whatever the conv's dtype, and the global batch's (two-pass, through
    differentiable all-reduces) under ``group``. Returns (w_fold_scale,
    bias_fold, new_st, new_qs)."""
    gamma, beta = p['gamma'], p['beta']
    if train:
        out32 = out_f.to(torch.float32)                      # NHWC
        if group is None:
            n = out32.shape[0] * out32.shape[1] * out32.shape[2]
            batch_mean = out32.mean((0, 1, 2))
            bv = out32.var((0, 1, 2), unbiased=False)
        else:
            batch_mean, bv, n = batch_moments(out32, (0, 1, 2), group,
                                              one_pass=False)
        bv = bv * n / max(n - 1, 1)
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


def _conv(x, w, lyr, compute_dtype, rows=None):
    """The conv's MACs in ``compute_dtype`` (None: as given); the result in
    x's dtype. ``rows``: x holds this rank's rows of the image, split over
    that group (``ops/conv.conv_rows_nhwc`` adds the halo)."""
    stride = lyr.stride_xy or lyr.stride
    x, pad = conv_ops.conv_rows_nhwc(x, lyr.size, stride, lyr.pad, rows)
    if compute_dtype is not None:
        y = conv_ops.conv2d_nhwc(x.to(compute_dtype), w.to(compute_dtype),
                                 stride=stride, padding=pad,
                                 groups=lyr.groups)
        return y.to(x.dtype)
    return conv_ops.conv2d_nhwc(x, w, stride=stride, padding=pad,
                                groups=lyr.groups)


def _fold_quant_weights(cfg, lyr, p, st, qs, *, train, warmup=False,
                        bn_frozen=False, compute_dtype=None, x=None,
                        group=None, model_group=None):
    """BN fold + weight/bias quantization of one conv, per scheme. Returns
    (qw OIHW, qb, st, qs); trackers and statistics update only when
    ``train`` (the statistics conv runs on ``x`` then, unless
    ``bn_frozen``, its statistics over ``group`` too); ``warmup`` records
    TPSQ's search winners in qs.

    ``model_group``: this conv's output channels are split over it
    (``split_group``), ``p`` holds this rank's block of them. The BN
    statistics are per channel, so they span the data group alone; every
    per-tensor quantity of the weight and the bias (google's range,
    cos-PTQ's cosines, DoReFa's max, ternary's means, TPSQ's warmup
    search) spans the model group and never the data group, whose ranks
    hold the same weights. TPSQ's ``w_scale``/``b_scale``, whole on every
    rank, pass through ``copy_to_model``, so that their gradient is the
    whole tensor's on every rank."""
    from . import quant_legacy as QL
    sch = cfg.scheme
    mg = model_group
    if lyr.bn:
        stat_fold = train and not bn_frozen
        out_f = _conv(x, p['w'], lyr, compute_dtype) if stat_fold else None
        inv, bias, st, qs = _bn_fold(p, st, qs, out_f, stat_fold, cfg,
                                     group)
        w_fold = p['w'] * inv[:, None, None, None]
    else:
        w_fold = p['w']
        bias = p['b'] if 'b' in p else torch.zeros(
            p['w'].shape[0], dtype=torch.float32, device=p['w'].device)
    qs = dict(qs)
    if sch == 'google':
        qw, qs['wq'] = google_quantize(w_fold, qs['wq'], bits=cfg.w_bits,
                                       train=train,
                                       freeze_step=cfg.scale_freeze_step,
                                       track='global', group=mg)
        qb, qs['bq'] = google_quantize(bias, qs['bq'], bits=cfg.w_bits,
                                       train=train,
                                       freeze_step=cfg.scale_freeze_step,
                                       track='global', group=mg)
    elif sch == 'tpsq':
        if warmup:
            qs['w_scale'] = _tpsq_search_scale(w_fold, cfg.w_bits, mg)
            qs['b_scale'] = _tpsq_search_scale(bias, cfg.w_bits, mg)
        scale = lambda f: qs[f] if warmup else copy_to_model(p[f], mg)
        qw = tpsq_quantize(w_fold, scale('w_scale'), cfg.w_bits)
        qb = tpsq_quantize(bias, scale('b_scale'), cfg.w_bits)
    elif sch == 'dorefa':
        # the folded weight and bias both go through the tanh quantizer
        qw = QL.dorefa_weight(w_fold, cfg.w_bits, mg)
        qb = QL.dorefa_weight(bias, cfg.w_bits, mg)
    elif sch == 'wbin':
        qw, qb = QL.binary_weight(w_fold), bias
    elif sch == 'ternary':
        qw, qb = QL.ternary_weight(w_fold, group=mg), bias
    else:   # ptq_cos
        qw, qs['wq'] = cospt_quantize(w_fold, qs['wq'], bits=cfg.w_bits,
                                      train=train, group=mg)
        qb, qs['bq'] = cospt_quantize(bias, qs['bq'], bits=cfg.w_bits,
                                      train=train, group=mg)
    return qw, qb, st, qs


def prepare_eval_params(net: NetworkIR, cfg: QuantConfig, params, state,
                        qstate, model_group=None):
    """The eval-constant work of each quantized conv hoisted out of the
    batch: a copy of ``params`` whose convs also hold ``qw``/``qb``, the
    BN-folded, fake-quantized weight and bias that the eval sim then uses
    as they are (the same floats as the unprepared eval). ``model_group``:
    ``params`` hold this rank's blocks of the split convs, and each gets
    its block of ``qw``/``qb``; google, cos-PTQ and TPSQ read stored
    scales, DoReFa and ternary reduce over the group (every rank of it
    calls this)."""
    out = {k: dict(v) for k, v in params.items()}
    for lyr in net.layers:
        if lyr.kind not in ('conv', 'depthwise'):
            continue
        k = str(lyr.index)
        qw, qb, _, _ = _fold_quant_weights(
            cfg, lyr, params[k], state.get(k, {}), qstate.get(k, {}),
            train=False, model_group=split_group(lyr, params[k]['w'],
                                                 model_group))
        out[k]['qw'], out[k]['qb'] = qw, qb
    return out


def _add_sliced(x, a):
    """Darknet shortcut add with channel mismatch: add into the leading
    channels, or slice the added map."""
    nx_, na_ = x.shape[-1], a.shape[-1]
    if nx_ == na_:
        return x + a
    if nx_ > na_:
        return torch.cat([x[..., :na_] + a, x[..., na_:]], -1)
    return x + a[..., :nx_]


def _fusion_weights(lyr, params, dtype):
    """A weighted shortcut's fusion weights sigmoid(w) * 2 / (n + 1)."""
    w = params[str(lyr.index)]['w']
    return (torch.sigmoid(w) * (2.0 / (len(lyr.layers) + 1))).to(dtype)


def make_quant_apply(net: NetworkIR, cfg: QuantConfig, compute_dtype=None,
                     warmup: bool = False, head_layout: str = 'anchor_major',
                     heads_only: bool = False, bn_frozen: bool = False,
                     eval_snap_dtype=None, capture_trace: bool = False):
    """Build the fake-quant apply of ``cfg.scheme`` on NHWC inputs:

    apply(params, state, qstate, x, train=False, group=None,
          spatial=None, model_group=None) ->
      train: ((yolo_p, feats), new_state, new_qstate)
      eval:  (io, yolo_p, feats), or (head_out, [None] * n) with
             ``heads_only``

    ``capture_trace`` appends ``{str(layer index): output}`` of every layer
    to the return, in both modes (the per-layer dump of
    ``compress/fpga_export.py``); not with ``heads_only``. ``group``: the
    data group of a data-parallel train step (module docstring).
    ``model_group`` (tensor parallelism, train and eval): the params hold
    this rank's blocks of the split convs (``parallel.shard_state``); each
    runs its block on the ``copy_to_model``'d input and gathers the
    activation whole before its quantizer (``_fold_quant_weights`` for the
    weight's reductions), so every tracker, shortcut and concat sees whole
    tensors and spans the data group alone, and every rank of a data
    index returns the same outputs and quantizer state.
    ``spatial`` (eval only; spatial partitioning): the group over whose
    ranks the image's rows are split, ``x`` holding this rank's
    (``parallel.shard_spatial``): each conv takes its halo rows, the pools,
    SE and avgpool follow ``ops/conv``'s row rules, and the head maps are
    gathered whole before the decode, so every rank returns one process's
    outputs (its feats and trace hold its rows). ``train=True`` with
    ``spatial`` raises ValueError: training on split rows is not
    supported.

    conv and depthwise conv -> BN-fold quantized conv with a quantized
    activation; shortcut -> requantized add (min or max way) and multi-route
    -> requantized concat for google and ptq_cos, float for the others; SE,
    avgpool, scale_channels and [batchnorm] -> float. Train mode updates
    the range trackers, votes, scales and BN statistics, and is
    differentiable (QAT): autograd runs through the BN fold with batch
    statistics and its statistics conv, and through every fake-quant.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): the dtype of the conv MACs
    and of the activations between layers; the quantizer, tracker and
    BN-fold math stays f32 (a fake-quant edge is an 8-bit grid value times
    a pow-2 scale, exact in bf16). ``warmup``: TPSQ's scale search (see
    ``tpsq_warmup``). ``head_layout``: 'anchor_major' emits yolo_p as
    (bs, na, ny, nx, no), 'nhwc' as (bs, ny, nx, na, no), a free reshape
    (``apply.head_layout``). ``bn_frozen``: the post-freeze QAT step
    without the statistics conv, the BN fold on the running statistics,
    which it leaves where they are (``apply.make_bn_frozen()`` builds it).

    ``eval_snap_dtype`` (e.g. ``torch.bfloat16``): in eval mode the
    activation, shortcut and concat quantize chains of the tracker scheme
    run in that dtype (``fq(snap_dtype=...)``); train mode keeps f32. A
    conv whose params hold ``qw``/``qb`` (``prepare_eval_params``) uses
    them in eval. ``apply.make_heads_only()`` builds the heads-only twin of
    an apply."""
    assert not (heads_only and capture_trace)
    check_supported(net, cfg.scheme)
    from . import quant_legacy as QL
    layers = net.layers
    sch = cfg.scheme
    bits = cfg.a_bits
    qmin, qmax = qrange(bits, True)
    qr = max(abs(qmin), abs(qmax))

    snap = lambda train: None if train else eval_snap_dtype

    def qconv(lyr, p, st, qs, x, train, group, rows, model_group):
        mg = split_group(lyr, p['w'], model_group)
        # a split conv: its block of the filters between copy_to_model and
        # the gather (models/network.py); the statistics conv of the BN
        # fold reads the same input
        x = copy_to_model(x, mg)
        if not train and 'qw' in p:
            qw, qb = p['qw'], p['qb']
        else:
            qw, qb, st, qs = _fold_quant_weights(
                cfg, lyr, p, st, qs, train=train, warmup=warmup,
                bn_frozen=bn_frozen, compute_dtype=compute_dtype, x=x,
                group=group, model_group=mg)
        out = _conv(x, qw, lyr, compute_dtype, rows)
        # qb sits on an 8-bit grid: exact in the compute dtype
        out = out + qb.to(out.dtype)
        # the DoReFa modules' leaky slope is 0.125
        dorefa_leaky = (sch == 'dorefa' and lyr.activation == 'leaky'
                        and not cfg.maxabsscaler)
        out = _activation(lyr.activation, cfg.maxabsscaler,
                          0.125 if dorefa_leaky else None)(out)
        if mg is not None:
            # the whole activation before its quantizer, which is then
            # elementwise given a per-tensor scale of the data group alone
            out = gather_channels(out.permute(0, 3, 1, 2), mg).permute(
                0, 2, 3, 1)
        if sch == 'google':
            out, qs['aq'] = google_quantize(out, qs['aq'], bits=bits,
                                            train=train,
                                            freeze_step=cfg.scale_freeze_step,
                                            track='ema',
                                            snap_dtype=eval_snap_dtype,
                                            group=group)
        elif sch == 'tpsq':
            if warmup:
                qs['a_scale'] = _tpsq_search_scale(out, bits)
            out = tpsq_quantize(out, qs['a_scale'] if warmup
                                else p['a_scale'], bits)
        elif sch == 'dorefa':
            # the heads (linear convs) skip the activation quantizer
            if lyr.activation not in ('linear', 'none'):
                out = QL.dorefa_activation(out, bits)
        elif sch == 'ptq_cos':
            out, qs['aq'] = cospt_quantize(out, qs['aq'], bits=bits,
                                           train=train, group=group)
        # wbin, ternary: weight-only, float activations
        qs['step'] = qs['step'] + 1
        return out, st, qs

    def qshortcut(lyr, params, qs, x, outs, train, group):
        """Requantized residual add: way 1 (min range) shares an input
        scale and tracks the QUANTIZED sum; way 2 (max range) tracks the
        float sum up front and uses one scale for x, a and the sum."""
        w = None
        if lyr.weighted:
            w = _fusion_weights(lyr, params, x.dtype)
            x = x * w[0]
        for i, j in enumerate(lyr.layers):
            a = outs[j]
            if w is not None:
                a = a * w[i + 1]
            if train:
                qs['x'] = _update_range(qs['x'], x.detach(), 'ema', group)
                qs['a'] = _update_range(qs['a'], a.detach(), 'ema', group)
                if cfg.shortcut_way == 2:
                    # the overlapping channels only, not _add_sliced
                    c = min(x.shape[-1], a.shape[-1])
                    s = x[..., :c] + a[..., :c]
                    qs['sum'] = _update_range(qs['sum'], s.detach(), 'ema',
                                              group)
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
            sd = snap(train)
            if cfg.shortcut_way == 2:
                in_scale = qs['scale']
                xq = fq(x, in_scale, 0.0, bits, snap_dtype=sd)
                aq = fq(a, in_scale, 0.0, bits, snap_dtype=sd)
            elif sd is not None:
                # the min way's round without clamp, in the snap dtype
                scd = qs['input_scale'].to(sd)
                xq = (round_half_away(x.to(sd) / scd) * scd).to(x.dtype)
                aq = (round_half_away(a.to(sd) / scd) * scd).to(a.dtype)
            else:
                # min way: round without clamp, in f32 (JAX promotes a bf16
                # activation with the f32 scale, and so does the sum on)
                in_scale = qs['input_scale']
                xf, af = x.to(torch.float32), a.to(torch.float32)
                xq = xf + (round_half_away(xf / in_scale) * in_scale
                           - xf).detach()
                aq = af + (round_half_away(af / in_scale) * in_scale
                           - af).detach()
            s = _add_sliced(xq, aq)
            if train and cfg.shortcut_way == 1:
                qs['sum'] = _update_range(qs['sum'], s.detach(), 'ema', group)
                qs['scale'] = pow2_snap(torch.maximum(
                    torch.abs(qs['sum']['min']),
                    torch.abs(qs['sum']['max']))) / qr
            x = fq(s, qs['scale'], 0.0, bits, snap_dtype=sd)
        return x, qs

    def fshortcut(lyr, params, x, outs):
        """The float shortcut of the schemes without requantization."""
        w = _fusion_weights(lyr, params, x.dtype) if lyr.weighted else None
        if w is not None:
            x = x * w[0]
        for i, j in enumerate(lyr.layers):
            a = outs[j]
            x = _add_sliced(x, a if w is None else a * w[i + 1])
        return x

    def qconcat(lyr, qs, outs, train, group):
        """Requantized concat: per-source EMA |max| list, one common pow-2
        scale = snap(max of the list)."""
        parts = [outs[j] for j in lyr.layers]
        if train:
            fmaxs = []
            for i, t in enumerate(parts):
                mn, mx = _min_max(t.detach(), group)
                m = torch.maximum(mx, torch.abs(mn))
                old = qs['float_max'][i]
                fmaxs.append(torch.where(old == 0, m, old * (1 - EMA_MOMENTUM)
                                         + m * EMA_MOMENTUM))
            fl = torch.stack(fmaxs)
            qs = {**qs, 'float_max': fl, 'scale': pow2_snap(torch.max(fl)) / qr}
        parts = [fq(t, qs['scale'], 0.0, bits, snap_dtype=snap(train))
                 for t in parts]
        return torch.cat(parts, -1), qs

    yolos = [l for l in layers if l.kind == 'yolo']
    anchor_cache: dict = {}

    def apply(params, state, qstate, x, train: bool = False, group=None,
              spatial=None, model_group=None):
        if train and spatial is not None:
            raise ValueError('the sim takes split rows (spatial) in eval '
                             'mode only: training on split rows is not '
                             'supported')
        rows = conv_ops.RowSplit(spatial)
        outs: dict[int, Any] = {}
        trace: dict[str, Any] = {}
        yolo_p, head_out, feats = [], [], []
        new_state = dict(state)
        new_q = {k: dict(v) for k, v in qstate.items()}
        prev = x if compute_dtype is None else x.to(compute_dtype)
        for lyr in layers:
            k = str(lyr.index)
            kind = lyr.kind
            sp = rows.split
            if kind in ('conv', 'depthwise'):
                st = state.get(k, {})
                prev, st2, new_q[k] = qconv(lyr, params[k], st, new_q[k],
                                            prev, train, group, sp,
                                            model_group)
                if st:
                    new_state[k] = st2
            elif kind == 'batchnorm':
                p, st = params[k], state[k]
                xc = prev.permute(0, 3, 1, 2)
                if train:
                    y, m, v = conv_ops.batch_norm_train(
                        xc, p['gamma'], p['beta'], st['mean'], st['var'],
                        LONE_BN_EPS, LONE_BN_MOM, group=group)
                    new_state[k] = {'mean': m, 'var': v}
                else:
                    y = conv_ops.batch_norm_infer(xc, p['gamma'], p['beta'],
                                                  st['mean'], st['var'],
                                                  LONE_BN_EPS)
                prev = y.permute(0, 2, 3, 1)
            elif kind == 'maxpool':
                prev = conv_ops.max_pool_nhwc(prev, lyr.size, lyr.stride,
                                              group=sp)
            elif kind == 'se':
                prev = conv_ops.se_block_nhwc(prev, params[k]['fc1'],
                                              params[k]['fc2'], group=sp)
            elif kind == 'avgpool':
                prev = conv_ops.global_avg_pool_nhwc(prev, group=sp)
            elif kind == 'scale_channels':
                prev = outs[lyr.layers[0]] * prev
            elif kind == 'upsample':
                prev = conv_ops.upsample_nearest_nhwc(prev, lyr.stride)
            elif kind == 'route':
                if len(lyr.layers) > 1:
                    if k in new_q:
                        prev, new_q[k] = qconcat(lyr, new_q[k], outs, train,
                                                 group)
                    else:
                        prev = torch.cat([outs[j] for j in lyr.layers], -1)
                elif lyr.route_groups:
                    prev = prev[..., prev.shape[-1] // 2:]
                else:
                    prev = outs[lyr.layers[0]]
            elif kind == 'shortcut':
                if k in new_q:
                    prev, new_q[k] = qshortcut(lyr, params, new_q[k], prev,
                                               outs, train, group)
                else:
                    prev = fshortcut(lyr, params, prev, outs)
            elif kind == 'yolo':
                h = prev if sp is None else all_gather_dim(prev, 1, sp)
                if head_layout == 'nhwc':
                    bs_, ny_, nx_, _ = h.shape
                    yolo_p.append(h.reshape(bs_, ny_, nx_, lyr.na, lyr.no))
                else:
                    yolo_p.append(reshape_pred(h, lyr.na, lyr.no))
                head_out.append(h)
            elif kind == 'reorg3d':
                prev = conv_ops.space_to_depth_nhwc(prev, lyr.stride)
            # dropout: identity
            rows.after(lyr)
            if lyr.is_routed:
                outs[lyr.index] = prev
            if lyr.feature_out:
                feats.append(prev)
            if capture_trace:
                trace[k] = prev

        if train:
            out = (yolo_p, feats), new_state, new_q
        elif heads_only:
            return head_out, [None] * len(head_out)
        else:
            anchors = anchors_on(yolos, anchor_cache, head_out[0].device)
            io = torch.cat([decode_yolo_nhwc(h, a, l.yolo_stride, l.no)
                            for h, a, l in zip(head_out, anchors, yolos)], 1)
            out = io, yolo_p, feats
        return (*out, trace) if capture_trace else out

    apply.qcfg = cfg
    apply.head_layout = head_layout
    apply.eval_snap_dtype = eval_snap_dtype
    if not heads_only:
        apply.make_heads_only = lambda: make_quant_apply(
            net, cfg, compute_dtype=compute_dtype, heads_only=True,
            eval_snap_dtype=eval_snap_dtype)
    if not bn_frozen:
        apply.make_bn_frozen = lambda: make_quant_apply(
            net, cfg, compute_dtype=compute_dtype, head_layout=head_layout,
            bn_frozen=True, eval_snap_dtype=eval_snap_dtype)
    return apply


def quantize_input_16bit(x):
    """Fixed Q14 input quantization for 16-bit activations."""
    x = x * (1 << 14)
    return round_half_away(x) / (1 << 14)


def bn_fuse_weights(net: NetworkIR, params, state):
    """The export-time BN fold of every conv: {layer index: (w_fold, bias)}
    as numpy f32, w_fold in the JAX package's HWIO layout (the FPGA
    exporter's input, ``compress/fpga_export.py``), computed as JAX's
    numpy fold computes it."""
    import numpy as np

    def host(f, t):
        a = t.detach().to('cpu', torch.float32).numpy()
        return a.transpose(2, 3, 1, 0) if f == 'w' and a.ndim == 4 else a

    out = {}
    for lyr in net.layers:
        if lyr.kind not in ('conv', 'depthwise'):
            continue
        k = str(lyr.index)
        p = {f: host(f, v) for f, v in params[k].items()}
        if lyr.bn:
            st = {f: host(f, v) for f, v in state[k].items()}
            inv = p['gamma'] / np.sqrt(st['var'] + BN_EPS)
            w = p['w'] * inv[None, None, None, :]
            b = (p['beta'] + (p.get('b', 0) - st['mean']) * inv
                 if 'b' in p else p['beta'] - st['mean'] * inv)
        else:
            w, b = p['w'], p.get('b', np.zeros(lyr.filters, np.float32))
        out[lyr.index] = (w, b)
    return out
