"""A Darknet detector in plain PyTorch: the cfg, the float forward, the
train-mode forward, and the google and cos-PTQ fake-quant schemes.

Written from the Darknet cfg semantics and the schemes' definitions (the
reference repository's ``models.py``, ``utils/layers.py``,
``utils/quantized``), for the layer kinds of yolov3, yolov4 and the
mobile backbones (MobileNetV3, arXiv:1905.02244; GhostNet,
arXiv:1911.11907; EfficientNet-B0, arXiv:1905.11946):
- convolutional and depthwise (batch-normalised or biased; ``groups=``,
  a depthwise conv's groups its input channels; zero padding of
  (size - 1) // 2 where ``pad`` is set, else none). Activations: leaky
  0.1, mish, relu, relu6, h_swish ``x relu6(x + 3) / 6``, swish
  ``x sigmoid(x)``, logistic, and linear (``none`` too);
- se: the mean over H and W, ``relu(y @ fc1.T) @ fc2.T``, the hard
  sigmoid gate ``clip(y + 3, 0, 6) / 6`` times the input's channels; its
  reduction from the cfg (4 where it gives ``filters``); the fc layers
  have no bias, as the source's;
- avgpool (the global mean over H and W), scale_channels (the ``from``
  layer times the previous output, a gate of 1 x 1), dropout (the
  identity, as at inference);
- shortcut (one ``from`` layer; of unequal widths, the sum into the
  leading channels or the added map cut to the input's, as the source's
  ``Shortcut``), route (one source, or a concat; with ``groups``, the
  ``group_id``-th of as many equal parts of its one source), maxpool
  (``-inf`` padding of (size - 1) // 2), nearest upsample and yolo.
The quantized schemes quantize every conv, depthwise and grouped ones
included, and leave se, avgpool and scale_channels float, as the
program's sim does. Departures: ``pad`` set means (size - 1) // 2, the
program's rule, where Darknet takes size / 2 (the same for odd sizes);
a ``[se]`` that gives ``filters`` takes that width. Not written, as no
cfg of these families has them: a lone [BatchNorm2d], reorg3d,
weighted shortcuts and ASFF heads.
Tensors are NCHW; weights are OIHW (a grouped conv's ``cin / groups``
wide), keyed by layer index as ``{'w', 'gamma', 'beta'}`` or ``{'w',
'b'}`` with BN statistics ``{'mean', 'var'}``; an se's ``{'fc1', 'fc2'}``
in the Linear layout (out, in).

``cast``, where a function takes it, rounds both operands of every conv
(the control of a lower precision); None leaves them in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

BN_EPS = 1e-5                # a conv's batch norm
BN_MOMENTUM = 0.1            # its running statistics in training
QBN_MOMENTUM = 0.01          # the quantized conv's running statistics
RANGE_MOMENTUM = 0.1         # the activation range trackers


@dataclass
class Layer:
    index: int
    kind: str                    # conv | maxpool | upsample | route | shortcut |
                                 # se | avgpool | scale_channels | dropout | yolo
    cin: int
    cout: int
    size: int = 1
    stride: int = 1
    pad: int = 0                 # a conv's zero padding on each side
    groups: int = 1              # a conv's groups; a route's equal parts
    bn: bool = False
    act: str = 'linear'
    src: tuple = ()              # absolute indices of route / shortcut /
                                 # scale_channels inputs
    reduction: int = 4           # se: fc1 maps cout to cout // reduction
    part: int = 0                # route: the one of its groups it takes
    anchors: tuple = ()          # yolo: (w, h) pixel anchors of its mask
    nc: int = 0
    head: bool = False           # a conv that feeds a yolo layer


def parse(lines) -> list[dict]:
    """Darknet cfg text lines -> blocks of string values, [net] first."""
    blocks = []
    for raw in lines:
        line = raw.split('#')[0].strip()
        if not line:
            continue
        if line.startswith('['):
            blocks.append({'type': line[1:-1].strip()})
        else:
            key, val = line.split('=', 1)
            blocks[-1][key.strip()] = val.strip()
    return blocks


def build(lines, in_ch: int = 3) -> list[Layer]:
    """The layer list of a cfg, with every layer's channel counts."""
    out_ch, layers = [], []
    ints = lambda v: [int(t) for t in v.split(',')]
    for i, b in enumerate(parse(lines)[1:]):
        kind = b['type']
        cin = out_ch[-1] if out_ch else in_ch
        absolute = lambda v: tuple(i + t if t < 0 else t for t in ints(v))
        if kind in ('convolutional', 'depthwise'):
            size = int(b['size'])
            lyr = Layer(i, 'conv', cin, int(b['filters']), size=size,
                        stride=int(b['stride']),
                        pad=(size - 1) // 2 if int(b.get('pad', 0)) else 0,
                        groups=(cin if kind == 'depthwise'
                                else int(b.get('groups', 1))),
                        bn=bool(int(b.get('batch_normalize', 0))),
                        act=b.get('activation', 'linear'))
        elif kind == 'se':
            c = (int(b['filters']) if 'filters' in b and 'reduction' not in b
                 else cin)
            lyr = Layer(i, 'se', cin, c, reduction=int(b.get('reduction', 4)))
        elif kind in ('avgpool', 'dropout'):
            lyr = Layer(i, kind, cin, cin)
        elif kind == 'scale_channels':
            src = absolute(b['from'])
            lyr = Layer(i, kind, cin, out_ch[src[0]], src=src)
        elif kind == 'maxpool':
            lyr = Layer(i, 'maxpool', cin, cin, size=int(b['size']),
                        stride=int(b['stride']))
        elif kind == 'upsample':
            lyr = Layer(i, 'upsample', cin, cin, stride=int(b['stride']))
        elif kind == 'route':
            src = absolute(b['layers'])
            lyr = Layer(i, 'route', cin, sum(out_ch[j] for j in src), src=src,
                        groups=int(b.get('groups', 1)),
                        part=int(b.get('group_id', 0)))
            lyr.cout //= lyr.groups
        elif kind == 'shortcut':
            lyr = Layer(i, 'shortcut', cin, cin, src=absolute(b['from']))
        elif kind == 'yolo':
            a = [float(t) for t in b['anchors'].split(',')]
            pairs = list(zip(a[0::2], a[1::2]))
            lyr = Layer(i, 'yolo', cin, cin, nc=int(b['classes']),
                        anchors=tuple(pairs[m] for m in ints(b['mask'])))
            layers[-1].head = True
        else:
            raise ValueError(f'layer {i}: no reference for [{kind}]')
        layers.append(lyr)
        out_ch.append(lyr.cout)
    return layers


def convs(layers):
    return [l for l in layers if l.kind == 'conv']


def hard_sigmoid(y):
    return torch.clamp(y + 3.0, 0.0, 6.0) / 6.0


_ACTS = {'leaky': lambda y: torch.where(y >= 0, y, y * 0.1),
         'mish': lambda y: y * torch.tanh(F.softplus(y)),
         'relu': torch.relu,
         'relu6': lambda y: torch.clamp(y, 0.0, 6.0),
         'h_swish': lambda y: y * hard_sigmoid(y),
         'swish': lambda y: y * torch.sigmoid(y),
         'logistic': torch.sigmoid,
         'linear': lambda y: y,
         'none': lambda y: y}


def _act(name):
    if name not in _ACTS:
        raise ValueError(f'activation {name!r}')
    return _ACTS[name]


def _conv(x, w, lyr, cast=None):
    if cast is not None:
        x, w = cast(x), cast(w)
    return F.conv2d(x, w, stride=lyr.stride, padding=lyr.pad,
                    groups=lyr.groups)


def add_sliced(x, a):
    """A shortcut's sum: of equal widths, x + a; else a into x's leading
    channels, or a cut to x's width."""
    nx, na = x.shape[1], a.shape[1]
    if nx == na:
        return x + a
    if nx > na:
        return torch.cat([x[:, :na] + a, x[:, na:]], 1)
    return x + a[:, :nx]


def se(x, p):
    """Squeeze and excitation with the hard sigmoid gate."""
    y = torch.relu(x.mean((2, 3)) @ p['fc1'].T) @ p['fc2'].T
    return x * hard_sigmoid(y)[:, :, None, None]


def _walk(layers, params, x, conv, shortcut=None, concat=None):
    """Run the graph: ``conv(lyr, x)``, and for the quantized schemes
    ``shortcut(lyr, x, a)`` and ``concat(lyr, parts)``; se, avgpool and
    scale_channels in float; returns the head maps, NCHW."""
    outs, heads, prev = {}, [], x
    for lyr in layers:
        if lyr.kind == 'conv':
            prev = conv(lyr, prev)
        elif lyr.kind == 'se':
            prev = se(prev, params[str(lyr.index)])
        elif lyr.kind == 'avgpool':
            prev = prev.mean((2, 3), keepdim=True)
        elif lyr.kind == 'scale_channels':
            prev = outs[lyr.src[0]] * prev
        elif lyr.kind == 'maxpool' and (lyr.size, lyr.stride) == (2, 1):
            # yolov3-tiny's: one zero row and column at the bottom right
            prev = F.max_pool2d(F.pad(prev, (0, 1, 0, 1)), 2, 1)
        elif lyr.kind == 'maxpool':
            p = (lyr.size - 1) // 2
            prev = F.max_pool2d(prev, lyr.size, lyr.stride, padding=p)
        elif lyr.kind == 'upsample':
            prev = F.interpolate(prev, scale_factor=lyr.stride, mode='nearest')
        elif lyr.kind == 'route':
            parts = [outs[j] for j in lyr.src]
            if lyr.groups > 1:
                parts = [t[:, lyr.part * lyr.cout:(lyr.part + 1) * lyr.cout]
                         for t in parts]
            prev = (parts[0] if len(parts) == 1 else
                    concat(lyr, parts) if concat else torch.cat(parts, 1))
        elif lyr.kind == 'shortcut':
            a = outs[lyr.src[0]]
            prev = shortcut(lyr, prev, a) if shortcut else add_sliced(prev, a)
        elif lyr.kind == 'yolo':
            heads.append(prev)
        # dropout: the identity
        outs[lyr.index] = prev
    return heads


def fold(p, st):
    """(w, b) of a conv with its BN folded in on running statistics."""
    if 'gamma' not in p:
        return p['w'], p['b']
    inv = p['gamma'] / torch.sqrt(st['var'] + BN_EPS)
    return p['w'] * inv[:, None, None, None], p['beta'] - st['mean'] * inv


def forward(layers, params, state, x, cast=None):
    """Eval-mode head maps from an NCHW f32 batch."""
    def conv(lyr, x):
        k = str(lyr.index)
        w, b = fold(params[k], state.get(k))
        return _act(lyr.act)(_conv(x, w, lyr, cast) + b[:, None, None])
    return _walk(layers, params, x, conv)


def forward_train(layers, params, x, cast=None, stats=None):
    """Train-mode head maps: each BN normalises by its batch's mean and
    biased variance over (N, H, W). ``stats``, a dict, receives each BN
    conv's batch mean and unbiased variance, detached."""
    def conv(lyr, x):
        p = params[str(lyr.index)]
        y = _conv(x, p['w'], lyr, cast)
        if lyr.bn:
            m = y.mean((0, 2, 3), keepdim=True)
            v = (y - m).square().mean((0, 2, 3), keepdim=True)
            if stats is not None:
                n = y.shape[0] * y.shape[2] * y.shape[3]
                stats[str(lyr.index)] = {
                    'mean': m.detach().reshape(-1),
                    'var': v.detach().reshape(-1) * n / (n - 1)}
            y = ((y - m) * torch.rsqrt(v + BN_EPS) * p['gamma'][:, None, None]
                 + p['beta'][:, None, None])
        else:
            y = y + p['b'][:, None, None]
        return _act(lyr.act)(y)
    return _walk(layers, params, x, conv)


def batch_statistics(layers, params, x):
    """BN running statistics of one batch in eval form: each BN conv's
    batch mean and unbiased variance, the network run in train mode."""
    stats = {}

    def conv(lyr, x):
        p = params[str(lyr.index)]
        y = _conv(x, p['w'], lyr)
        if lyr.bn:
            m = y.mean((0, 2, 3))
            v = (y - m[:, None, None]).square().mean((0, 2, 3))
            n = y.shape[0] * y.shape[2] * y.shape[3]
            stats[str(lyr.index)] = {'mean': m, 'var': v * n / (n - 1)}
            y = ((y - m[:, None, None]) * torch.rsqrt(v + BN_EPS)[:, None, None]
                 * p['gamma'][:, None, None] + p['beta'][:, None, None])
        else:
            y = y + p['b'][:, None, None]
        return _act(lyr.act)(y)
    with torch.no_grad():
        _walk(layers, params, x, conv)
    return stats


# ---------------------------------------------------------- fake quantization

def round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def pow2_snap(x):
    """The nearest power of two by linear distance, a tie to the lower."""
    x = torch.clamp_min(x, 1e-38)
    lo, hi = torch.exp2(torch.floor(torch.log2(x))), torch.exp2(
        torch.ceil(torch.log2(x)))
    return torch.where(torch.abs(hi - x) < torch.abs(lo - x), hi, lo)


def fake_quant(x, scale, bits):
    q = 2 ** (bits - 1)
    return torch.clamp(round_half_away(x / scale), -q, q - 1) * scale


class Tracker:
    """A min/max range tracker: 'ema' averages the ranges of the batches
    (the first taken whole); 'global' keeps the current batch's range
    widened to include zero after the first batch (the reference
    tracker's aliasing)."""

    def __init__(self, how, dev):
        self.how, self.seen = how, False
        self.min = self.max = torch.zeros((), device=dev)

    def update(self, x):
        mn, mx = x.min(), x.max()
        if not self.seen:
            self.min, self.max = mn, mx
        elif self.how == 'ema':
            self.min = self.min * (1 - RANGE_MOMENTUM) + mn * RANGE_MOMENTUM
            self.max = self.max * (1 - RANGE_MOMENTUM) + mx * RANGE_MOMENTUM
        else:
            self.min = torch.minimum(torch.zeros_like(mn), mn)
            self.max = torch.maximum(torch.zeros_like(mx), mx)
        self.seen = True

    def scale(self, bits):
        return pow2_snap(torch.maximum(self.min.abs(), self.max.abs())) / (
            2 ** (bits - 1))


class Quantizer:
    """One quantized tensor's scale: google (a tracker, frozen after
    ``freeze`` updates) or cos-PTQ (each calibration batch votes for the
    float range 2^(i - 5), i < bits + 7, whose grid has the largest
    cosine with it; the most-voted range wins)."""

    def __init__(self, scheme, bits, how, freeze, dev):
        self.scheme, self.bits, self.freeze = scheme, bits, freeze
        self.tracker, self.steps = Tracker(how, dev), 0
        self.votes = torch.zeros(bits + 7, device=dev)
        self.s = torch.ones((), device=dev)

    def __call__(self, x, train):
        if train:
            if self.scheme == 'google':
                if self.steps < self.freeze:
                    self.tracker.update(x)
                    self.s = self.tracker.scale(self.bits)
            else:
                self._vote(x.reshape(-1))
            self.steps += 1
        return fake_quant(x, self.s, self.bits)

    def _vote(self, flat):
        qr = 2 ** (self.bits - 1)
        n = self.bits + 7
        xn = flat / torch.clamp_min(flat.norm(), 1e-12)
        cos = []
        for i in range(n):
            dq = fake_quant(flat, 2.0 ** (i - 5) / qr, self.bits)
            cos.append(torch.dot(dq, xn) / torch.clamp_min(dq.norm(), 1e-12))
        self.votes[int(torch.argmax(torch.stack(cos)))] += 1
        self.s = torch.exp2(torch.argmax(self.votes).float() - 5.0) / qr


class QuantSim:
    """The fake-quant network of one scheme ('google' or 'ptq_cos') at
    ``bits`` for weights and activations: every conv's BN folded into its
    weight and quantized with its bias and its output (depthwise and
    grouped convs as any other; se, avgpool and scale_channels float);
    shortcuts add inputs rounded to a shared grid and requantize the sum;
    concats requantize their sources to one grid. ``calibrate`` runs a
    train-mode batch (BN on batch statistics until ``bn_freeze``, then on
    running ones; the trackers and votes update), ``heads`` an eval batch.

    ``steps`` is the calibration length the scheme's freeze steps are
    taken from: BN statistics freeze at 90% of it, google's scales at
    10%."""

    def __init__(self, layers, params, state, scheme, bits, steps, dev):
        self.layers, self.params, self.bits = layers, params, bits
        self.bn_freeze = int(steps * 0.9)
        scale_freeze = int(steps * 0.1)
        q = lambda how: Quantizer(scheme, bits, how, scale_freeze, dev)
        self.state = {k: dict(v) for k, v in state.items()}
        self.first = {k: True for k in self.state}
        self.conv_q = {str(l.index): (q('global'), q('global'), q('ema'))
                       for l in convs(layers)}
        self.calls = {k: 0 for k in self.conv_q}
        self.sc = {str(l.index): [Tracker('ema', dev) for _ in range(3)]
                   + [torch.ones((), device=dev)] * 2
                   for l in layers if l.kind == 'shortcut'}
        self.cat = {str(l.index): [torch.zeros(len(l.src), device=dev),
                                   torch.ones((), device=dev)]
                    for l in layers if l.kind == 'route' and len(l.src) > 1}

    def _fold(self, lyr, x, train):
        k = str(lyr.index)
        p = self.params[k]
        if not lyr.bn:
            return p['w'], p['b']
        st = self.state[k]
        mean, var = st['mean'], st['var']
        if train:
            y = _conv(x, p['w'], lyr)
            n = y.shape[0] * y.shape[2] * y.shape[3]
            bm = y.mean((0, 2, 3))
            bv = (y - bm[:, None, None]).square().mean((0, 2, 3)) * n / (n - 1)
            empty = bool((mean == 0).all() and (var == 0).all())
            if self.first[k] and empty:
                new_m, new_v = bm, bv
            else:
                new_m = mean * (1 - QBN_MOMENTUM) + bm * QBN_MOMENTUM
                new_v = var * (1 - QBN_MOMENTUM) + bv * QBN_MOMENTUM
            self.first[k] = False
            self.state[k] = {'mean': new_m, 'var': new_v}
            if self.calls[k] < self.bn_freeze:
                mean, var = bm, bv
            else:
                mean, var = new_m, new_v
        inv = p['gamma'] / torch.sqrt(var + BN_EPS)
        return p['w'] * inv[:, None, None, None], p['beta'] - mean * inv

    def _conv(self, lyr, x, train):
        k = str(lyr.index)
        w, b = self._fold(lyr, x, train)
        wq, bq, aq = self.conv_q[k]
        y = _conv(x, wq(w, train), lyr) + bq(b, train)[:, None, None]
        self.calls[k] += 1
        return aq(_act(lyr.act)(y), train)

    def _shortcut(self, lyr, x, a, train):
        tx, ta, ts, in_s, s = self.sc[str(lyr.index)]
        qr = 2 ** (self.bits - 1)
        if train:
            tx.update(x)
            ta.update(a)
            hi = torch.minimum(tx.max, ta.max)
            lo = torch.maximum(tx.min, ta.min)
            in_s = pow2_snap(torch.maximum(lo.abs(), hi.abs())) / qr
        total = add_sliced(round_half_away(x / in_s) * in_s,
                           round_half_away(a / in_s) * in_s)
        if train:
            ts.update(total)
            s = ts.scale(self.bits)
            self.sc[str(lyr.index)] = [tx, ta, ts, in_s, s]
        return fake_quant(total, s, self.bits)

    def _concat(self, lyr, parts, train):
        fmax, s = self.cat[str(lyr.index)]
        if train:
            new = []
            for i, t in enumerate(parts):
                m = torch.maximum(t.max(), t.min().abs())
                new.append(m if fmax[i] == 0 else
                           fmax[i] * (1 - RANGE_MOMENTUM) + m * RANGE_MOMENTUM)
            fmax = torch.stack(new)
            s = pow2_snap(fmax.max()) / 2 ** (self.bits - 1)
            self.cat[str(lyr.index)] = [fmax, s]
        return torch.cat([fake_quant(t, s, self.bits) for t in parts], 1)

    @torch.no_grad()
    def run(self, x, train):
        return _walk(self.layers, self.params, x,
                     lambda l, t: self._conv(l, t, train),
                     lambda l, t, a: self._shortcut(l, t, a, train),
                     lambda l, p: self._concat(l, p, train))

    def calibrate(self, x):
        self.run(x, True)

    def heads(self, x):
        return self.run(x, False)


def macs(layers, size):
    """Multiply-adds of every conv of one image of ``size`` x ``size``, in
    network order, with each conv's input and output side: (layer, h_in,
    h_out, macs), a grouped conv's ``cin / groups`` wide."""
    hw, out, cur = {}, [], size
    for lyr in layers:
        if lyr.kind == 'conv':
            src = cur
            cur = (src + 2 * lyr.pad - lyr.size) // lyr.stride + 1
            out.append((lyr, src, cur, cur * cur * lyr.cout * lyr.size ** 2
                        * (lyr.cin // lyr.groups)))
        elif lyr.kind == 'maxpool':
            cur = math.ceil(cur / lyr.stride)
        elif lyr.kind == 'upsample':
            cur = cur * lyr.stride
        elif lyr.kind == 'avgpool':
            cur = 1
        elif lyr.kind in ('route', 'scale_channels'):
            cur = hw[lyr.src[0]]
        hw[lyr.index] = cur
    return out
