"""Darknet ``.weights`` load/save (counterpart of yolo_tpu/models/darknet_io.py).

File layout: a header of 3 int32 (version) and 1 int64 (images seen), then
float32 parameters in layer order. Per layer:

  conv+bn:    bn_beta, bn_gamma, bn_running_mean, bn_running_var, conv_w (OIHW)
  conv nobn:  conv_bias, conv_w (OIHW)
  depthwise:  as conv
  se:         fc1.weight (out, in), fc2.weight (out, in)

The port keeps conv weights OIHW, so every field is a straight copy and a
load/save round trip is byte-identical.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ir import NetworkIR

HEADER_VERSION = np.array([0, 2, 5], dtype=np.int32)
_CUTOFF_BY_FILE = {'darknet53.conv.74': 75, 'yolov3-tiny.conv.15': 15}


def load_darknet_weights(net: NetworkIR, params, state, path,
                         cutoff: int = -1, pt: bool = False):
    """Read a .weights file into copies of (params, state).

    Returns (params, state, version, seen). ``cutoff`` loads layers
    [0, cutoff) and is set for the standard backbone files; ``pt`` skips the
    255-channel COCO head convs of a pretrained file."""
    cutoff = _CUTOFF_BY_FILE.get(Path(path).name, cutoff)
    with open(path, 'rb') as f:
        version = np.fromfile(f, dtype=np.int32, count=3)
        seen = np.fromfile(f, dtype=np.int64, count=1)
        weights = np.fromfile(f, dtype=np.float32)

    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    ptr = 0

    def take(shape):
        nonlocal ptr
        n = int(np.prod(shape))
        if ptr + n > len(weights):
            raise ValueError(f'{path}: weight file too short at offset {ptr}')
        a = torch.from_numpy(weights[ptr:ptr + n].reshape(shape).copy())
        ptr += n
        return a

    skip_heads = pt and str(path).endswith('.weights')
    for lyr in (net.layers if cutoff == -1 else net.layers[:cutoff]):
        k = str(lyr.index)
        if lyr.kind in ('conv', 'depthwise'):
            o, i, s = lyr.filters, lyr.in_channels // lyr.groups, lyr.size
            if lyr.bn:
                params[k]['beta'] = take((o,))
                params[k]['gamma'] = take((o,))
                state[k]['mean'] = take((o,))
                state[k]['var'] = take((o,))
                params[k]['w'] = take((o, i, s, s))
            elif skip_heads:
                ptr += 255 + i * 255 * s * s
            else:
                params[k]['b'] = take((o,))
                params[k]['w'] = take((o, i, s, s))
        elif lyr.kind == 'se':
            c, r = lyr.filters, lyr.reduction
            params[k]['fc1'] = take((c // r, c))
            params[k]['fc2'] = take((c, c // r))

    if cutoff == -1 and not pt and ptr != len(weights):
        raise ValueError(f'{path}: weight file not fully consumed '
                         f'({ptr} of {len(weights)} floats)')
    return params, state, version, seen


def save_darknet_weights(net: NetworkIR, params, state, path,
                         cutoff: int = -1, version=None, seen=None):
    """Write (params, state) in darknet .weights layout."""
    version = HEADER_VERSION if version is None else np.asarray(version, np.int32)
    seen = np.array([0], np.int64) if seen is None else np.asarray(seen, np.int64)

    def put(f, t):
        t.detach().to('cpu', torch.float32).contiguous().numpy().tofile(f)

    with open(path, 'wb') as f:
        version.tofile(f)
        seen.tofile(f)
        for lyr in (net.layers if cutoff == -1 else net.layers[:cutoff]):
            k = str(lyr.index)
            if lyr.kind in ('conv', 'depthwise'):
                p = params[k]
                if lyr.bn:
                    for t in (p['beta'], p['gamma'], state[k]['mean'],
                              state[k]['var']):
                        put(f, t)
                else:
                    put(f, p['b'])
                put(f, p['w'])
            elif lyr.kind == 'se':
                put(f, params[k]['fc1'])
                put(f, params[k]['fc2'])
