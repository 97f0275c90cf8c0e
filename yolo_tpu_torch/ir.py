"""Typed graph IR for Darknet-defined networks.

The port's own copy of ``yolo_tpu/ir.py`` (numpy only): the cfg is
compiled once into a typed layer graph, which ``models/network.py``,
``compress/quant.py`` and ``models/int8_engine.py`` walk layer by layer.
``tests/test_torch_ops.py`` holds the two copies to the same IR on every
cfg under ``cfg/``.

Construction semantics mirror reference ``create_modules`` (models.py:11-347):
channel bookkeeping, route/shortcut index resolution, routed-layer marking,
YOLO stride-order reversal for yolov4/panet/cd53 cfgs, tiny-maxpool zero-pad,
and the smart-bias flag for YOLO-preceding convs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .config import parse_model_cfg


@dataclass
class LayerIR:
    """One node of the network graph."""
    index: int
    kind: str                       # conv | depthwise | batchnorm | maxpool |
                                    # se | upsample | route | shortcut |
                                    # reorg3d | yolo
    mdef: dict = field(default_factory=dict)   # raw cfg block (round-trips to .cfg)
    in_channels: int = 0
    filters: int = 0                # output channels
    # conv / depthwise / maxpool / upsample
    size: int = 0
    stride: int = 1
    stride_xy: tuple[int, int] | None = None   # (sy, sx) anisotropic stride
    pad: int = 0
    groups: int = 1
    bn: bool = False
    activation: str = 'linear'
    # route / shortcut (absolute source-layer indices)
    layers: tuple[int, ...] = ()
    route_groups: bool = False      # yolov4-tiny half-channel split route
    weighted: bool = False          # BiFPN-style weighted shortcut
    # se
    reduction: int = 4
    # yolo
    anchors: Any = None             # (na, 2) ndarray, pixels
    nc: int = 0
    yolo_index: int = -1
    yolo_stride: int = 0
    # bookkeeping
    is_routed: bool = False         # some later layer reads this output
    feature_out: bool = False       # collected for KD (models.py:542-543)
    smart_bias: bool = False        # YOLO-preceding conv bias init

    @property
    def na(self) -> int:
        return 0 if self.anchors is None else len(self.anchors)

    @property
    def no(self) -> int:
        return self.nc + 5


@dataclass
class NetworkIR:
    layers: list[LayerIR]
    in_channels: int
    cfg_name: str
    module_defs: list[dict]          # [net] block + per-layer blocks (mutable copy)

    @property
    def yolo_layers(self) -> list[int]:
        return [l.index for l in self.layers if l.kind == 'yolo']

    @property
    def nc(self) -> int:
        for l in self.layers:
            if l.kind == 'yolo':
                return l.nc
        return 0

    def replace(self, layers: list[LayerIR]) -> 'NetworkIR':
        return dataclasses.replace(self, layers=layers)


def _abs_index(i: int, l: int) -> int:
    return i + l if l < 0 else l


def build_ir(cfg, is_gray_scale: bool = False, cfg_name: str | None = None) -> NetworkIR:
    """Compile parsed cfg blocks (or a cfg path) into a NetworkIR.

    Mirrors reference create_modules channel/rout bookkeeping
    (models.py:11-347) without instantiating any runtime modules.
    ``cfg_name`` lets callers passing a block list keep the yolov4/panet
    stride-order behaviour tied to the original cfg path.
    """
    if isinstance(cfg, (str, bytes)) or hasattr(cfg, '__fspath__'):
        cfg_name = str(cfg) if cfg_name is None else cfg_name
        mdefs = parse_model_cfg(cfg)
    else:
        cfg_name = '' if cfg_name is None else cfg_name
        mdefs = [dict(m) for m in cfg]

    net_block = mdefs[0]
    body = mdefs[1:]
    in_ch0 = 1 if is_gray_scale else 3
    output_filters = [in_ch0]
    layers: list[LayerIR] = []
    routs: set[int] = set()
    yolo_index = -1

    for i, mdef in enumerate(body):
        kind = mdef['type']
        lyr = LayerIR(index=i, kind=kind, mdef=mdef,
                      in_channels=output_filters[-1], filters=output_filters[-1])

        if kind in ('convolutional', 'depthwise'):
            lyr.kind = 'conv' if kind == 'convolutional' else 'depthwise'
            lyr.bn = bool(int(mdef['batch_normalize']))
            lyr.filters = int(mdef['filters'])
            lyr.size = int(mdef['size'])
            if 'stride' in mdef:
                lyr.stride = int(mdef['stride'])
            else:
                # anisotropic stride_x/stride_y (yolov3-spp-matrix.cfg; the
                # reference create_modules raises KeyError on these)
                lyr.stride_xy = (int(mdef['stride_y']), int(mdef['stride_x']))
            # darknet defaults pad=0 when absent (the reference create_modules
            # KeyErrors on pad-less convs, e.g. the efficientnetB0 SE 1x1s)
            lyr.pad = (lyr.size - 1) // 2 if int(mdef.get('pad', 0)) else 0
            lyr.groups = (lyr.in_channels if kind == 'depthwise'
                          else int(mdef.get('groups', 1)))
            lyr.activation = str(mdef.get('activation', 'linear'))

        elif kind == 'BatchNorm2d':
            lyr.kind = 'batchnorm'

        elif kind == 'maxpool':
            lyr.size = int(mdef['size'])
            lyr.stride = int(mdef['stride'])

        elif kind == 'avgpool':
            # global average pool (squeeze step of cfg-level SE blocks in the
            # efficientnetB0 zoo cfg; the reference create_modules has no case
            # for it and crashes — supported here for full zoo coverage)
            pass

        elif kind == 'scale_channels':
            # channel-wise multiply of the `from` feature map by the incoming
            # 1x1 gate (excite step); output takes the `from` layer's shape
            src = mdef['from']
            src = src if isinstance(src, list) else [src]
            lyr.filters = output_filters[src[0] + 1 if src[0] > 0 else src[0]]
            lyr.layers = tuple(_abs_index(i, l) for l in src)
            routs.update(lyr.layers)

        elif kind == 'se':
            # reference models.py:217-222: 'reduction' variant overrides and
            # uses the incoming channel count; 'filters' variant sets channels.
            if 'reduction' in mdef:
                lyr.reduction = int(mdef['reduction'])
                lyr.filters = output_filters[-1]
            elif 'filters' in mdef:
                lyr.filters = int(mdef['filters'])

        elif kind == 'upsample':
            lyr.stride = int(mdef['stride'])

        elif kind == 'route':
            src = mdef['layers']
            # reference quirk preserved: positive index l reads
            # output_filters[l + 1], l == 0 reads the network input channels
            # (models.py:229)
            lyr.filters = sum(output_filters[l + 1 if l > 0 else l] for l in src)
            if 'groups' in mdef:
                lyr.filters //= 2
                lyr.route_groups = True
            lyr.layers = tuple(_abs_index(i, l) for l in src)
            routs.update(lyr.layers)

        elif kind == 'shortcut':
            src = mdef['from']
            lyr.filters = output_filters[-1]
            lyr.layers = tuple(_abs_index(i, l) for l in src)
            lyr.weighted = 'weights_type' in mdef
            routs.update(lyr.layers)

        elif kind == 'reorg3d':
            # real space-to-depth: H,W /= stride, C *= stride^2. The
            # reference no-ops this block (models.py:307-308), which leaves
            # its only user (yolov3-spp-pan-scale.cfg) crashing at the
            # following PAN concats; here it runs for real (ASFF precedent).
            lyr.stride = int(mdef.get('stride', 2))
            lyr.filters = output_filters[-1] * lyr.stride ** 2

        elif kind == 'dropout':
            # extension: efficientnetB0 cfg carries [dropout] blocks the
            # reference cannot parse; rate stored in mdef['probability']
            pass

        elif kind == 'yolo':
            yolo_index += 1
            mask = mdef['mask']
            lyr.anchors = np.asarray(mdef['anchors'], dtype=np.float32)[mask]
            lyr.nc = int(mdef['classes'])
            lyr.yolo_index = yolo_index
            # stride assigned by static downsample analysis below; this
            # subsumes the reference's hardcoded [32,16,8] (+reversal for
            # yolov4/panet/cd53, models.py:312-315) and also handles cfgs with
            # more than 3 heads that crash the reference (yolov3-spp-matrix).
            # smart bias init on the preceding conv (models.py:325-335)
            j = (_abs_index(i, mdef['from'][yolo_index]) if 'from' in mdef
                 else i - 1)
            if 0 <= j < len(layers) and layers[j].kind == 'conv':
                layers[j].smart_bias = True
            # yolo 'from' = all scales' head maps (reference models.py:316
            # `layers=`, consumed only by the dead ASFF branch :381-399).
            # Recorded + routed so make_apply(asff=True) can fuse them.
            if 'from' in mdef:
                lyr.layers = tuple(_abs_index(i, v) for v in mdef['from'])
                routs.update(lyr.layers)
        else:
            raise ValueError(f'Unrecognized layer type: {kind}')

        layers.append(lyr)
        output_filters.append(lyr.filters)

    for idx in routs:
        if 0 <= idx < len(layers):
            layers[idx].is_routed = True

    # Static downsample analysis: cumulative stride of every layer's output
    # relative to the input image; YOLO layers read the factor of their input.
    factor = [1] * len(layers)
    prev_f = 1
    for i, lyr in enumerate(layers):
        f = prev_f
        if lyr.kind in ('conv', 'depthwise'):
            f = prev_f * (lyr.stride_xy[0] if lyr.stride_xy else lyr.stride)
        elif lyr.kind == 'maxpool':
            f = prev_f * lyr.stride
        elif lyr.kind == 'upsample':
            f = max(prev_f // lyr.stride, 1)
        elif lyr.kind == 'reorg3d':
            f = prev_f * lyr.stride
        elif lyr.kind in ('route', 'scale_channels'):
            f = factor[lyr.layers[0]] if lyr.layers and lyr.layers[0] < i else prev_f
        elif lyr.kind == 'yolo':
            # ASFF cfgs trail ALL yolo blocks after the last head conv, so
            # the walk predecessor's stride is wrong for every scale but
            # the finest; each scale decodes on its own `from=` source map
            # (subsumes the reference's hardcoded stride[yolo_index]).
            src = (lyr.layers[lyr.yolo_index]
                   if lyr.yolo_index < len(lyr.layers) else -1)
            lyr.yolo_stride = factor[src] if 0 <= src < i else prev_f
        factor[i] = f
        prev_f = f

    # feature_out: outputs of Sequential-wrapped blocks (conv/depthwise/
    # tiny-maxpool/se) whose successor is not a YOLO layer (models.py:542-543)
    for i, lyr in enumerate(layers):
        seq_like = (lyr.kind in ('conv', 'depthwise', 'se') or
                    (lyr.kind == 'maxpool' and lyr.size == 2 and lyr.stride == 1))
        next_is_yolo = i + 1 < len(layers) and layers[i + 1].kind == 'yolo'
        lyr.feature_out = seq_like and not next_is_yolo

    return NetworkIR(layers=layers, in_channels=in_ch0, cfg_name=cfg_name,
                     module_defs=mdefs)
