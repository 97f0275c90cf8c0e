"""Darknet detector as an ``nn.Module`` built from a ``NetworkIR``.

Counterpart of ``yolo_tpu/models/network.py``: the eval forward (with BN,
or with BN folded by ``fuse_params``), the ``heads_only`` outputs that feed
the sparse-decode NMS, test-time augmentation (``Darknet.forward_augment``,
the JAX package's ``make_augmented_apply``) and the train forward
(``Darknet.forward_train``, JAX's ``apply(..., train=True)``: BN on batch
statistics, trainable f32 parameters cast to the compute dtype at each
use).
Every layer kind of the cfgs under ``cfg/`` runs: conv and depthwise conv,
standalone BN, maxpool, SE, global avgpool, scale_channels, reorg3d,
route, shortcut, upsample, dropout, and yolo heads, ASFF ones included.

Params and state are dicts keyed by layer-index strings, as in the JAX
package: ``params[k]`` holds ``w`` (OIHW), ``b`` or ``gamma``/``beta``,
the weighted-shortcut ``w``; ``state[k]`` holds the BN ``mean``/``var``.
``yolo_tpu_torch.convert`` moves them to and from the JAX pytrees.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import ir as ir_mod

from ..ops import activations as act_mod
from ..ops import conv as conv_ops
from ..ops.conv import CONV_BN_EPS, CONV_BN_MOM, LONE_BN_EPS, LONE_BN_MOM
from .yolo_head import decode_yolo_nhwc, reshape_pred

SUPPORTED_KINDS = ('conv', 'depthwise', 'batchnorm', 'maxpool', 'se',
                   'avgpool', 'scale_channels', 'reorg3d', 'route',
                   'shortcut', 'upsample', 'yolo', 'dropout')
CONV_KINDS = ('conv', 'depthwise')


def _asff_yolo(net: ir_mod.NetworkIR) -> set[int]:
    """Indices of yolo layers that fuse all scales (ASFF): their ``from``
    head convs carry na*no + nl channels, the last nl of them the per-pixel
    scale weights."""
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
    [BatchNorm2d] is the imagenet input normaliser; SE fc weights are
    uniform in +-1/sqrt(fan_in); weighted shortcuts start at zero; and
    convs feeding a yolo layer get the smart head bias (objectness -4.5,
    classes log(0.6 / (nc - 0.99)))."""
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
        if lyr.kind in CONV_KINDS:
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
        elif lyr.kind == 'se':
            c, r = lyr.filters, lyr.reduction
            params[k] = {'fc1': uniform((c // r, c), -1, 1) / math.sqrt(c),
                         'fc2': uniform((c, c // r), -1, 1)
                         / math.sqrt(c // r)}
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
        if lyr.kind in CONV_KINDS and lyr.bn and k in state:
            p = fused[k]
            w, b = conv_ops.fuse_conv_bn(p['w'], p.get('b'), p['gamma'],
                                         p['beta'], state[k]['mean'],
                                         state[k]['var'], CONV_BN_EPS)
            fused[k] = {'w': w, 'b': b}
    return fused


class _LayerTensors(nn.Module):
    """One layer's tensors: params as frozen Parameters in ``dtype`` (or,
    ``trainable``, as trainable f32 copies), BN state as f32 buffers."""

    def __init__(self, params: dict, state: dict, dtype: torch.dtype,
                 trainable: bool = False):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(
                t.detach().to(torch.float32, copy=True) if trainable
                else t.to(dtype), requires_grad=trainable))
        for name, t in state.items():
            self.register_buffer(name, t.to(torch.float32, copy=trainable))


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
    from the host (a host-to-device copy would synchronise the stream).

    ``trainable``: the parameters are trainable f32 copies under the JAX
    key names (``layer[k].w``, ``gamma``, ``beta``, ``b``, ``fc1``/``fc2``,
    the weighted shortcut's ``w``) and every use casts them to ``dtype``
    (``None``: f32, no cast), so that the compute-dtype gradient flows back
    into the f32 master weight; ``forward_train`` runs the train mode."""

    def __init__(self, net: ir_mod.NetworkIR, params, state=None, *,
                 fused: bool = False, maxabsscaler: bool = False,
                 dtype: torch.dtype | None = torch.float32,
                 trainable: bool = False):
        super().__init__()
        check_supported(net)
        state = state or {}
        for lyr in net.layers:
            if lyr.kind in CONV_KINDS:
                p = params[str(lyr.index)]
                want = ('w', 'b') if (fused or not lyr.bn) else ('w', 'gamma',
                                                                  'beta')
                if any(f not in p for f in want) or (
                        lyr.bn and not fused and str(lyr.index) not in state):
                    raise ValueError(f'layer {lyr.index}: params do not match '
                                     f'fused={fused} (need {want})')
        self.net = net
        self.fused = fused
        self.dtype = torch.float32 if dtype is None else dtype
        self.layer = nn.ModuleDict({k: _LayerTensors(v, state.get(k, {}),
                                                     self.dtype, trainable)
                                    for k, v in params.items()})
        self._act = {l.index: act_mod.get(l.activation, maxabsscaler)
                     for l in net.layers if l.kind in CONV_KINDS}
        self._yolos = [l for l in net.layers if l.kind == 'yolo']
        for i, l in enumerate(self._yolos):
            self.register_buffer(f'anchors{i}', torch.as_tensor(
                l.anchors, dtype=torch.float32), persistent=False)
        self._asff = _asff_yolo(net)
        # head conv index -> the yolo layer right after it, where the slim
        # objectness conv applies (same pairing rule as the JAX package; an
        # ASFF head's objectness lives in the fused map, so it has none)
        self._head_conv = {}
        for i, lyr in enumerate(net.layers):
            if lyr.kind == 'yolo' and i > 0 and lyr.index not in self._asff:
                hc = net.layers[i - 1]
                if (hc.kind == 'conv' and hc.groups == 1
                        and hc.activation in ('linear', None)
                        and (fused or not hc.bn)):
                    self._head_conv[hc.index] = lyr

    def anchors(self) -> list[torch.Tensor]:
        """Per-scale (na, 2) pixel anchors, f32, on the module's device."""
        return [getattr(self, f'anchors{i}') for i in range(len(self._yolos))]

    def _c(self, t):
        """A parameter in the compute dtype (a no-op for a frozen model)."""
        return t if t.dtype == self.dtype else t.to(self.dtype)

    def _bn(self, lyr, t, y, eps, momentum, train, new_state):
        if not train:
            return conv_ops.batch_norm_infer(y, t.gamma, t.beta, t.mean,
                                             t.var, eps)
        y, m, v = conv_ops.batch_norm_train(y, t.gamma, t.beta, t.mean, t.var,
                                            eps, momentum)
        new_state[str(lyr.index)] = {'mean': m, 'var': v}
        return y

    def _run(self, x, want_obj: bool, train: bool = False,
             head_layout: str = 'anchor_major'):
        prev = x.permute(0, 3, 1, 2).to(self.dtype)
        outs, pending = {}, {}
        heads, objs = [], []
        feats, new_state = [], {}
        head_convs = self._head_conv if want_obj else {}
        for lyr in self.net.layers:
            kind = lyr.kind
            if kind in CONV_KINDS:
                t = self.layer[str(lyr.index)]
                stride = lyr.stride_xy or lyr.stride
                w = self._c(t.w)
                if lyr.index in head_convs:
                    y = head_convs[lyr.index]
                    sl = slice(4, y.na * y.no, y.no)
                    pending[lyr.index] = conv_ops.conv2d(
                        prev, w[sl], stride=stride, padding=lyr.pad,
                        bias=self._c(t.b)[sl])
                if lyr.bn and not self.fused:
                    y = conv_ops.conv2d(prev, w, stride=stride,
                                        padding=lyr.pad, groups=lyr.groups)
                    y = self._bn(lyr, t, y, CONV_BN_EPS, CONV_BN_MOM, train,
                                 new_state)
                elif train:
                    # the JAX train forward adds the bias after the conv
                    y = conv_ops.conv2d(prev, w, stride=stride,
                                        padding=lyr.pad, groups=lyr.groups)
                    y = y + self._c(t.b)[:, None, None]
                else:
                    y = conv_ops.conv2d(prev, w, stride=stride,
                                        padding=lyr.pad, groups=lyr.groups,
                                        bias=self._c(t.b))
                prev = self._act[lyr.index](y)
            elif kind == 'batchnorm':
                t = self.layer[str(lyr.index)]
                prev = self._bn(lyr, t, prev, LONE_BN_EPS, LONE_BN_MOM, train,
                                new_state)
            elif kind == 'maxpool':
                prev = conv_ops.max_pool(prev, lyr.size, lyr.stride)
            elif kind == 'se':
                t = self.layer[str(lyr.index)]
                prev = conv_ops.se_block(prev, t.fc1, t.fc2)
            elif kind == 'avgpool':
                prev = conv_ops.global_avg_pool(prev)
            elif kind == 'scale_channels':
                prev = outs[lyr.layers[0]] * prev
            elif kind == 'reorg3d':
                prev = conv_ops.space_to_depth(prev, lyr.stride)
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
                heads.append(self._asff_fuse(lyr, outs)
                             if lyr.index in self._asff
                             else prev.permute(0, 2, 3, 1))
                o = pending.get(lyr.index - 1)
                objs.append(None if o is None else o.permute(0, 2, 3, 1))
            # dropout: the identity, in train mode too (as in the JAX
            # package, which never drops)
            if lyr.is_routed:
                outs[lyr.index] = prev
            if train and lyr.feature_out:
                feats.append(prev.permute(0, 2, 3, 1))
        if not train:
            return heads, objs
        yolo_p = []
        for h, l in zip(heads, self._yolos):
            bs, ny, nx, _ = h.shape
            yolo_p.append(h.reshape(bs, ny, nx, l.na, l.no)
                          if head_layout == 'nhwc'
                          else reshape_pred(h, l.na, l.no))
        return (yolo_p, feats), new_state

    @staticmethod
    def _asff_fuse(lyr, outs):
        """The ASFF head map (NHWC, f32): this scale's map weighted by
        ``sigmoid(p[:, -n:]) * 2 / n``, plus the other scales' maps, each
        resized bilinearly (half-pixel centres, no antialias) to this grid
        and weighted likewise."""
        srcs = [outs[j].to(torch.float32) for j in lyr.layers]
        n, i = len(srcs), lyr.yolo_index
        p = srcs[i]
        w = torch.sigmoid(p[:, -n:]) * (2.0 / n)
        fused = p[:, :-n] * w[:, i:i + 1]
        size = tuple(p.shape[2:])
        for j, s in enumerate(srcs):
            if j != i:
                r = F.interpolate(s[:, :-n], size=size, mode='bilinear',
                                  align_corners=False)
                fused = fused + w[:, j:j + 1] * r
        return fused.permute(0, 2, 3, 1).contiguous()

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

    def forward_train(self, x, head_layout: str = 'anchor_major'):
        """The train forward (JAX ``apply(params, state, x, train=True)``):
        BN on batch statistics, no slim objectness conv. Returns
        ((yolo_p, feature_out), new_state): yolo_p per scale (bs, na, ny,
        nx, no), or (bs, ny, nx, na, no) with ``head_layout='nhwc'``;
        feature_out the NHWC maps of the ``feature_out`` layers; new_state
        the BN layers' new running mean and var (detached; the buffers are
        left as they are)."""
        return self._run(x, want_obj=False, train=True,
                         head_layout=head_layout)

    def forward_augment(self, x):
        """Test-time augmentation (the JAX package's
        ``make_augmented_apply``): the decoded io of the input, of its
        left-right flip scaled by 0.83 (boxes divided by 0.83, x centres
        flipped back against the input width) and of the input scaled by
        0.67 (boxes divided by 0.67), concatenated along the rows."""
        img_w = x.shape[2]
        io0 = self(x)
        io1 = self(scale_img(torch.flip(x, (2,)), 0.83))
        io1 = torch.cat([img_w - io1[..., :1] / 0.83, io1[..., 1:4] / 0.83,
                         io1[..., 4:]], -1)
        io2 = self(scale_img(x, 0.67))
        io2 = torch.cat([io2[..., :4] / 0.67, io2[..., 4:]], -1)
        return torch.cat([io0, io1, io2], 1)


def scale_img(x, ratio: float, same_shape: bool = False, gs: int = 64):
    """Scale an NHWC batch by ``ratio`` (bilinear, half-pixel centres, no
    antialias, in f32) to (int(h * ratio), int(w * ratio)), then pad the
    bottom and right with the grey 0.447 up to a multiple of ``gs`` (or
    back to the input size with ``same_shape``)."""
    if ratio == 1.0:
        return x
    _, h, w, _ = x.shape
    nh, nw = int(h * ratio), int(w * ratio)
    y = F.interpolate(x.permute(0, 3, 1, 2).to(torch.float32), size=(nh, nw),
                      mode='bilinear', align_corners=False).permute(0, 2, 3, 1)
    if not same_shape:
        h, w = math.ceil(h * ratio / gs) * gs, math.ceil(w * ratio / gs) * gs
    return F.pad(y, (0, 0, 0, max(w - nw, 0), 0, max(h - nh, 0)), value=0.447)
