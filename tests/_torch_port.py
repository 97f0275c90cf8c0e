"""Shared inputs of the yolo_tpu_torch tests (imports neither jax nor torch).

``TOY_CFG`` is a narrow yolov3-style detector (widths <= 32, nc=2, 64 px
input) that uses every layer kind the port supports: conv+BN with leaky and
mish, plain / weighted / channel-mismatched shortcuts, the tiny k=2/s=1
maxpool, route concat and route groups, upsample, dropout and two yolo
heads.
"""

import math

import numpy as np

TOY_CFG = """[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=mish

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear
weights_type=per_feature

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-4
activation=linear

[maxpool]
size=2
stride=1

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 3,4,5
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=2
num=6

[route]
layers=-3

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,8

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[dropout]
probability=0.2

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=2
num=6
"""


def random_jax_weights(net, seed=0, conv_scale=1.0):
    """(params, state) in the JAX package's layout (HWIO convs) as numpy
    f32, drawn from ``seed``: He-normal convs damped by ``conv_scale``,
    random BN statistics, random weighted-shortcut weights and the smart
    head bias, so the heads carry real detections."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    f32 = lambda a: np.asarray(a, np.float32)
    for lyr in net.layers:
        k = str(lyr.index)
        if lyr.kind in ('conv', 'depthwise'):
            i = lyr.in_channels // lyr.groups
            fan_in = i * lyr.size * lyr.size
            p = {'w': f32(rng.normal(0, conv_scale * math.sqrt(2 / fan_in),
                                     (lyr.size, lyr.size, i, lyr.filters)))}
            if lyr.bn:
                p['gamma'] = f32(rng.uniform(0.6, 1.4, lyr.filters))
                p['beta'] = f32(rng.normal(0, 0.1, lyr.filters))
                state[k] = {'mean': f32(rng.normal(0, 0.3, lyr.filters)),
                            'var': f32(rng.uniform(0.5, 2.0, lyr.filters))}
            else:
                b = rng.uniform(-0.05, 0.05, lyr.filters)
                y = net.layers[min(lyr.index + 1, len(net.layers) - 1)]
                if y.kind == 'yolo':
                    head = b[:y.na * y.no].reshape(y.na, y.no)
                    head[:, 4] -= 1.0
                p['b'] = f32(b)
            params[k] = p
        elif lyr.kind == 'shortcut' and lyr.weighted:
            params[k] = {'w': f32(rng.normal(0, 0.5, len(lyr.layers) + 1))}
        elif lyr.kind == 'se':
            c, r = lyr.filters, lyr.reduction
            params[k] = {'fc1': f32(rng.normal(0, 0.1, (c // r, c))),
                         'fc2': f32(rng.normal(0, 0.1, (c, c // r)))}
        elif lyr.kind == 'batchnorm':
            c = lyr.filters
            params[k] = {'gamma': f32(rng.uniform(0.6, 1.4, c)),
                         'beta': f32(rng.normal(0, 0.1, c))}
            state[k] = {'mean': f32(rng.normal(0, 0.3, c)),
                        'var': f32(rng.uniform(0.5, 2.0, c))}
    return params, state


def images(seed, bs, size):
    """A uint8 NHWC batch with smooth structure (not pure noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([np.sin(6 * xx), np.cos(5 * yy), np.sin(4 * (xx + yy))], -1)
    x = 127.5 + 80 * base[None] + rng.normal(0, 30, (bs, size, size, 3))
    return np.clip(x, 0, 255).astype(np.uint8)


def candidates(rng, bs, k):
    """Score-sorted candidate sets with heavy overlap (suppression chains):
    (boxes (bs, k, 4), scores (bs, k), valid (bs, k)) as numpy."""
    cx = rng.uniform(0, 200, (bs, k, 1))
    cy = rng.uniform(0, 200, (bs, k, 1))
    w = rng.uniform(5, 60, (bs, k, 1))
    h = rng.uniform(5, 60, (bs, k, 1))
    boxes = np.concatenate([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    scores = np.sort(rng.uniform(0.05, 1.0, (bs, k)))[:, ::-1].copy()
    return boxes.astype(np.float32), scores.astype(np.float32), scores > 0.1
