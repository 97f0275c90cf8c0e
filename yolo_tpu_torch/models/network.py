"""Darknet detector as an ``nn.Module`` built from a ``NetworkIR``.

Counterpart of ``yolo_tpu/models/network.py`` for inference: the eval
forward (with BN, or with BN folded by ``fuse_params``) and the
``heads_only`` outputs that feed the sparse-decode NMS.

Params and state are dicts keyed by layer-index strings, as in the JAX
package: ``params[k]`` holds ``w`` (OIHW), ``b`` or ``gamma``/``beta``,
the weighted-shortcut ``w``; ``state[k]`` holds the BN ``mean``/``var``.
``yolo_tpu_torch.convert`` moves them to and from the JAX pytrees.

Not ported yet (see ROADMAP.md): ASFF heads, reorg3d, se, avgpool,
scale_channels, depthwise and mixconv layers, and test-time augmentation.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import ir as ir_mod

from ..ops import activations as act_mod
from ..ops import conv as conv_ops
from .yolo_head import decode_yolo_nhwc

# per-conv BN vs standalone [BatchNorm2d] blocks (as in the JAX package)
CONV_BN_EPS = 1e-5
LONE_BN_EPS = 1e-4

SUPPORTED_KINDS = ('conv', 'batchnorm', 'maxpool', 'route', 'shortcut',
                   'upsample', 'yolo', 'dropout')


def _asff_yolo(net: ir_mod.NetworkIR) -> set[int]:
    """Indices of yolo layers that fuse all scales (ASFF)."""
    layers = net.layers
    return {l.index for l in layers
            if l.kind == 'yolo' and len(l.layers) >= 2
            and all(0 <= j < l.index
                    and layers[j].filters == l.na * l.no + len(l.layers)
                    for j in l.layers)}


def check_supported(net: ir_mod.NetworkIR):
    """Raise NotImplementedError naming the first layer kind the port lacks."""
    for lyr in net.layers:
        if lyr.kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                f'layer {lyr.index}: kind {lyr.kind!r} is not ported to '
                f'yolo_tpu_torch yet (see ROADMAP.md)')
    if _asff_yolo(net):
        raise NotImplementedError(
            'ASFF yolo heads are not ported to yolo_tpu_torch yet '
            '(see ROADMAP.md)')


def init_params(net: ir_mod.NetworkIR, generator: torch.Generator | None = None,
                *, conv_scale: float = 1.0):
    """Random (params, state) for ``net`` drawn from ``generator``.

    Conv weights are He-normal with std ``conv_scale * sqrt(2 / fan_in)``;
    a ``conv_scale`` below 1 damps residual towers. For yolov3, 1.0 makes
    the heads overflow, 0.6 leaves them at the bias prior (no box passes an
    eval threshold of 0.001), and 0.7 gives head maps of std 1 to 4. Conv
    biases are uniform in +-0.05; BN gets gamma in U(0.6, 1.4), beta ~ N(0, 0.1),
    running mean ~ N(0, 0.3) and var in U(0.5, 2) (identity BN would let the
    random activations die out over the depth); a leading 3-channel
    [BatchNorm2d] is the imagenet input normaliser; weighted shortcuts start
    at zero; and convs feeding a yolo layer get the smart head bias
    (objectness -4.5, classes log(0.6 / (nc - 0.99)))."""
    check_supported(net)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    uniform = lambda n, lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)
    normal = lambda n, std: std * torch.randn(n, generator=g)

    def bn(c):
        return ({'gamma': uniform(c, 0.6, 1.4), 'beta': normal(c, 0.1)},
                {'mean': normal(c, 0.3), 'var': uniform(c, 0.5, 2.0)})

    params: dict[str, dict] = {}
    state: dict[str, dict] = {}
    for lyr in net.layers:
        k = str(lyr.index)
        if lyr.kind == 'conv':
            shape = (lyr.filters, lyr.in_channels // lyr.groups, lyr.size,
                     lyr.size)
            std = conv_scale * math.sqrt(2.0 / math.prod(shape[1:]))
            params[k] = {'w': normal(shape, std)}
            if lyr.bn:
                p, state[k] = bn(lyr.filters)
                params[k].update(p)
            else:
                params[k]['b'] = uniform(lyr.filters, -0.05, 0.05)
        elif lyr.kind == 'batchnorm' and lyr.index == 0 and lyr.filters == 3:
            params[k] = {'gamma': torch.ones(3), 'beta': torch.zeros(3)}
            state[k] = {'mean': torch.tensor([0.485, 0.456, 0.406]),
                        'var': torch.tensor([0.0524, 0.0502, 0.0506])}
        elif lyr.kind == 'batchnorm':
            params[k], state[k] = bn(lyr.filters)
        elif lyr.kind == 'shortcut' and lyr.weighted:
            params[k] = {'w': torch.zeros(len(lyr.layers) + 1)}

    for lyr in net.layers:
        if lyr.kind == 'conv' and lyr.smart_bias and 'b' in params[str(lyr.index)]:
            y = next((y for y in net.layers[lyr.index + 1:] if y.kind == 'yolo'),
                     None)
            b = params[str(lyr.index)]['b']
            if y is not None and b.shape[0] >= y.na * y.no:
                head = b[:y.na * y.no].view(y.na, y.no)
                head[:, 4] -= 4.5
                head[:, 5:] += math.log(0.6 / (y.nc - 0.99))
    return params, state


def fuse_params(net: ir_mod.NetworkIR, params, state):
    """Fold each conv's BN into its weights and bias; the result feeds
    ``Darknet(..., fused=True)`` with an empty state."""
    fused = {k: dict(v) for k, v in params.items()}
    for lyr in net.layers:
        k = str(lyr.index)
        if lyr.kind == 'conv' and lyr.bn and k in state:
            p = fused[k]
            w, b = conv_ops.fuse_conv_bn(p['w'], p.get('b'), p['gamma'],
                                         p['beta'], state[k]['mean'],
                                         state[k]['var'], CONV_BN_EPS)
            fused[k] = {'w': w, 'b': b}
    return fused


class _LayerTensors(nn.Module):
    """One layer's tensors: params as frozen Parameters in ``dtype``, BN
    state as f32 buffers."""

    def __init__(self, params: dict, state: dict, dtype: torch.dtype):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(
                name, nn.Parameter(t.to(dtype), requires_grad=False))
        for name, t in state.items():
            self.register_buffer(name, t.to(torch.float32))


class Darknet(nn.Module):
    """Eval-mode detector over a ``NetworkIR``.

    ``forward(x)`` takes an NHWC batch (bs, H, W, C) and returns the decoded
    io (bs, N, 5+nc) in the row-major (y, x, a) order of
    ``decode_yolo_nhwc``: ``decode(heads(x))``. ``forward_heads(x)``
    returns the raw NHWC head maps (bs, ny, nx, na*no) and per-scale
    objectness-logit maps (bs, ny, nx, na) from a slim conv over the head
    conv's ``a*no + 4`` channels (None where the head conv is not a plain
    linear conv with a bias). ``fused`` says that conv BN has been folded by ``fuse_params``.

    The weights are held in ``dtype`` (the compute dtype; the input is cast
    to it), BN statistics and anchors in f32, as in the JAX package. Move
    it with ``.to(device, memory_format=torch.channels_last)``, without a
    dtype: the anchors live on the device, so the decode copies nothing
    from the host (a host-to-device copy would synchronise the stream)."""

    def __init__(self, net: ir_mod.NetworkIR, params, state=None, *,
                 fused: bool = False, maxabsscaler: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(net)
        state = state or {}
        for lyr in net.layers:
            if lyr.kind == 'conv':
                p = params[str(lyr.index)]
                want = ('w', 'b') if (fused or not lyr.bn) else ('w', 'gamma',
                                                                  'beta')
                if any(f not in p for f in want) or (
                        lyr.bn and not fused and str(lyr.index) not in state):
                    raise ValueError(f'layer {lyr.index}: params do not match '
                                     f'fused={fused} (need {want})')
        self.net = net
        self.fused = fused
        self.dtype = dtype
        self.layer = nn.ModuleDict({k: _LayerTensors(v, state.get(k, {}), dtype)
                                    for k, v in params.items()})
        self._act = {l.index: act_mod.get(l.activation, maxabsscaler)
                     for l in net.layers if l.kind == 'conv'}
        self._yolos = [l for l in net.layers if l.kind == 'yolo']
        for i, l in enumerate(self._yolos):
            self.register_buffer(f'anchors{i}', torch.as_tensor(
                l.anchors, dtype=torch.float32), persistent=False)
        # head conv index -> the yolo layer right after it, where the slim
        # objectness conv applies (same pairing rule as the JAX package)
        self._head_conv = {}
        for i, lyr in enumerate(net.layers):
            if lyr.kind == 'yolo' and i > 0:
                hc = net.layers[i - 1]
                if (hc.kind == 'conv' and hc.groups == 1
                        and hc.activation in ('linear', None)
                        and (fused or not hc.bn)):
                    self._head_conv[hc.index] = lyr

    def anchors(self) -> list[torch.Tensor]:
        """Per-scale (na, 2) pixel anchors, f32, on the module's device."""
        return [getattr(self, f'anchors{i}') for i in range(len(self._yolos))]

    def _run(self, x, want_obj: bool):
        prev = x.permute(0, 3, 1, 2).to(self.dtype)
        outs, pending = {}, {}
        heads, objs = [], []
        head_convs = self._head_conv if want_obj else {}
        for lyr in self.net.layers:
            kind = lyr.kind
            if kind == 'conv':
                t = self.layer[str(lyr.index)]
                stride = lyr.stride_xy or lyr.stride
                if lyr.index in head_convs:
                    y = head_convs[lyr.index]
                    sl = slice(4, y.na * y.no, y.no)
                    pending[lyr.index] = conv_ops.conv2d(
                        prev, t.w[sl], stride=stride, padding=lyr.pad,
                        bias=t.b[sl])
                if lyr.bn and not self.fused:
                    y = conv_ops.conv2d(prev, t.w, stride=stride,
                                        padding=lyr.pad, groups=lyr.groups)
                    y = conv_ops.batch_norm_infer(y, t.gamma, t.beta, t.mean,
                                                  t.var, CONV_BN_EPS)
                else:
                    y = conv_ops.conv2d(prev, t.w, stride=stride,
                                        padding=lyr.pad, groups=lyr.groups,
                                        bias=t.b)
                prev = self._act[lyr.index](y)
            elif kind == 'batchnorm':
                t = self.layer[str(lyr.index)]
                prev = conv_ops.batch_norm_infer(prev, t.gamma, t.beta, t.mean,
                                                 t.var, LONE_BN_EPS)
            elif kind == 'maxpool':
                prev = conv_ops.max_pool(prev, lyr.size, lyr.stride)
            elif kind == 'upsample':
                prev = conv_ops.upsample_nearest(prev, lyr.stride)
            elif kind == 'route':
                if len(lyr.layers) > 1:
                    prev = torch.cat([outs[j] for j in lyr.layers], 1)
                elif lyr.route_groups:
                    prev = prev[:, prev.shape[1] // 2:]
                else:
                    prev = outs[lyr.layers[0]]
            elif kind == 'shortcut':
                prev = self._shortcut(lyr, prev, outs)
            elif kind == 'yolo':
                heads.append(prev.permute(0, 2, 3, 1))
                o = pending.get(lyr.index - 1)
                objs.append(None if o is None else o.permute(0, 2, 3, 1))
            # dropout: identity at inference
            if lyr.is_routed:
                outs[lyr.index] = prev
        return heads, objs

    def _shortcut(self, lyr, x, outs):
        if lyr.weighted:
            w = torch.sigmoid(self.layer[str(lyr.index)].w) * (
                2.0 / (len(lyr.layers) + 1))
            x = x * w[0]
        nx = x.shape[1]
        for idx, j in enumerate(lyr.layers):
            a = outs[j]
            if lyr.weighted:
                a = a * w[idx + 1]
            na = a.shape[1]
            if nx == na:
                x = x + a
            elif nx > na:       # add into the leading channels
                x = torch.cat([x[:, :na] + a, x[:, na:]], 1)
            else:               # slice the added map
                x = x + a[:, :nx]
        return x

    def heads(self, x):
        """The raw NHWC head maps (bs, ny, nx, na*no) alone."""
        return self._run(x, want_obj=False)[0]

    def decode(self, heads):
        """Head maps -> decoded io (bs, N, 5+nc), f32."""
        return torch.cat([decode_yolo_nhwc(h, a, l.yolo_stride, l.no)
                          for h, a, l in zip(heads, self.anchors(), self._yolos)],
                         1)

    def forward(self, x):
        return self.decode(self.heads(x))

    def forward_heads(self, x):
        return self._run(x, want_obj=True)
