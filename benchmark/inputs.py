"""The benchmark's inputs, made on the device from ``--seed``: weights,
images and training targets. The same seed gives the same inputs.

Weights follow the port's init (He-normal convs times ``conv_scale``,
conv biases U(-0.05, 0.05), BN running mean N(0, 0.3), var U(0.5, 2),
the heads' objectness bias -4.5 and class bias log(0.6 / (nc - 0.99)))
but for BN's gamma and beta, whose ranges the configuration's form gives
(``init``): with the port's U(0.6, 1.4) and N(0, 0.1) a random yolov3 or
yolov4 whose BN runs on data statistics is chaotic, and one rounding of
bf16 moves its heads by 20-33%, so that no comparison can tell a right
answer from a wrong one; a smaller gamma beside a larger beta keeps the
random detector well conditioned. A grouped conv's weight is (cout, cin
/ groups, k, k), He-normal over that fan-in, in the same draw as every
conv's; an se's ``fc1`` (cout / reduction, cout) and ``fc2`` (cout, cout
/ reduction) are U(-1, 1) over the square root of their fan-in, the
port's init, in the Linear layout and on a stream of their own, so that
a network without se layers draws the tensors it drew before they were
added. Each kind is drawn in one call for the whole network by a
generator on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.darknet import convs


def generator(seed, dev, stream=0):
    """A generator on ``dev`` for draw ``stream`` of ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def _split(flat, sizes):
    out, at = [], 0
    for n in sizes:
        out.append(flat[at:at + n])
        at += n
    return out


def weights(layers, seed, init, dev):
    """(params, state): f32 tensors on ``dev`` keyed by layer index;
    ``init`` holds ``conv_scale``, ``bn_gamma`` (low, high) and
    ``bn_beta_std``."""
    conv_scale = init['conv_scale']
    g_lo, g_hi = init['bn_gamma']
    g = generator(seed, dev, 1)
    cs = convs(layers)
    shapes = [(l.cout, l.cin // l.groups, l.size, l.size) for l in cs]
    sizes = [math.prod(s) for s in shapes]
    w = torch.randn(sum(sizes), generator=g, device=dev)
    bn = [l for l in cs if l.bn]
    nb = sum(l.cout for l in bn)
    u = torch.rand(3 * nb, generator=g, device=dev)
    n = torch.randn(2 * nb, generator=g, device=dev)
    biased = [l for l in cs if not l.bn]
    b = torch.rand(sum(l.cout for l in biased), generator=g, device=dev)
    params, state = {}, {}
    for lyr, shape, flat in zip(cs, shapes, _split(w, sizes)):
        std = conv_scale * math.sqrt(2.0 / math.prod(shape[1:]))
        params[str(lyr.index)] = {'w': (flat * std).reshape(shape)}
    cols = [l.cout for l in bn]
    for lyr, gam, var, beta, mean in zip(
            bn, _split(u[:nb], cols), _split(u[nb:2 * nb], cols),
            _split(n[:nb], cols), _split(n[nb:], cols)):
        k = str(lyr.index)
        params[k].update(gamma=g_lo + (g_hi - g_lo) * gam,
                         beta=init['bn_beta_std'] * beta)
        state[k] = {'mean': 0.3 * mean, 'var': 0.5 + 1.5 * var}
    for lyr, flat in zip(biased, _split(b, [l.cout for l in biased])):
        bias = -0.05 + 0.1 * flat
        if lyr.head:
            nxt = layers[lyr.index + 1]
            head = bias.view(len(nxt.anchors), nxt.nc + 5)
            head[:, 4] -= 4.5
            head[:, 5:] += math.log(0.6 / (nxt.nc - 0.99))
        params[str(lyr.index)]['b'] = bias
    ses = [l for l in layers if l.kind == 'se']
    sizes = [l.cout * (l.cout // l.reduction) for l in ses]
    u = 2 * torch.rand(2 * sum(sizes), generator=generator(seed, dev, 5),
                       device=dev) - 1
    for lyr, fc1, fc2 in zip(ses, _split(u[:sum(sizes)], sizes),
                             _split(u[sum(sizes):], sizes)):
        c, r = lyr.cout, lyr.cout // lyr.reduction
        params[str(lyr.index)] = {'fc1': fc1.reshape(r, c) / math.sqrt(c),
                                  'fc2': fc2.reshape(c, r) / math.sqrt(r)}
    return params, state


def images(seed, n, size, dev):
    """(n, size, size, 3) uint8 images: smooth colour waves plus noise,
    each image's waves at its own phase."""
    g = generator(seed, dev, 2)
    yy, xx = torch.meshgrid(torch.arange(size, device=dev) / size,
                            torch.arange(size, device=dev) / size,
                            indexing='ij')
    phase = 6.2832 * torch.rand((n, 1, 1, 3), generator=g, device=dev)
    base = torch.stack([torch.sin(6 * xx), torch.cos(5 * yy),
                        torch.sin(4 * (xx + yy))], -1)[None]
    x = 127.5 + 80 * torch.sin(base * 3.1416 + phase) + 30 * torch.randn(
        (n, size, size, 3), generator=g, device=dev)
    return x.clamp(0, 255).to(torch.uint8)


def targets(seed, index, bs, nc, mean_extra=6.0, most=20, min_side=0.02,
            max_side=0.6):
    """(n, 6) f32 [image, class, x, y, w, h] for a batch of ``bs``: 1 +
    Poisson(``mean_extra``) boxes an image, at most ``most``, classes
    uniform over ``nc``, centres uniform, sides log-uniform between
    ``min_side`` and ``max_side`` of the image; numpy. ``index`` numbers
    the batches of one seed."""
    rng = np.random.default_rng([int(seed), 3, int(index)])
    rows = []
    for i in range(bs):
        k = min(1 + rng.poisson(mean_extra), most)
        side = np.exp(rng.uniform(np.log(min_side), np.log(max_side), (k, 2)))
        rows.append(np.column_stack([np.full(k, i), rng.integers(0, nc, k),
                                     rng.uniform(0, 1, (k, 2)), side]))
    return np.concatenate(rows).astype(np.float32)
