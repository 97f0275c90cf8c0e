"""Operations and bytes of the benchmark's kernels, from the cfg's shapes,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates): the numerators and denominators of the roofline shares and
of the whole step's share of the peak.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the peak rate for their type; each input byte is read
once and each output byte written once; a multiply-add is 2 operations.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12


def bound_ms(n_bytes, n_ops, ops_per_s):
    """The least time in ms of moving ``n_bytes`` and doing ``n_ops``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s) * 1e3


def conv_ops(convs, bs):
    """Operations of every conv of a batch of ``bs``: ``convs`` as
    ``reference.darknet.macs`` lists them."""
    return 2.0 * bs * sum(c[3] for c in convs)


# the int8 engine's float edges: the network input and the outputs of
# these layers (and of a lone [BatchNorm2d], which the reference does not
# write); a one-source route and the layers below carry their input's
# kind; every other layer's output is int8
FLOAT_EDGE_OUT = ('se', 'avgpool', 'scale_channels')
CARRY_EDGE = ('maxpool', 'upsample', 'dropout', 'yolo')


def _k2_takes(lyr):
    """The convs K2 takes (``ops/conv_int8.py`` ``supported``): 1x1 stride
    1 and 3x3 stride 1 or 2, 'same' padding, ungrouped."""
    return (lyr.groups == 1 and lyr.pad == lyr.size // 2
            and ((lyr.size == 1 and lyr.stride == 1)
                 or (lyr.size == 3 and lyr.stride in (1, 2))))


def engine_paths(layers):
    """How the int8 engine runs each conv, by layer index: 'k2' (K2) an
    ungrouped conv of a shape K2 takes on an int8 edge, 'grouped'
    (``grouped_conv_int8``) the other convs on an int8 edge, 'float'
    (``float_edge_conv``) a conv on a float edge."""
    edge, paths, prev = {}, {}, 'f'
    for lyr in layers:
        if lyr.kind == 'conv':
            paths[lyr.index] = ('float' if prev == 'f' else
                                'k2' if _k2_takes(lyr) else 'grouped')
            prev = 'q'
        elif lyr.kind in FLOAT_EDGE_OUT:
            prev = 'f'
        elif lyr.kind == 'route' and len(lyr.src) == 1:
            prev = edge[lyr.src[0]]
        elif lyr.kind not in CARRY_EDGE:
            prev = 'q'
        edge[lyr.index] = prev
    return paths


def _calls(convs, layers, path):
    paths = engine_paths(layers)
    return [c for c in convs if paths[c[0].index] == path]


def k2_calls(convs, layers):
    """The convs, as ``reference.darknet.macs`` lists them, that the int8
    engine runs through K2 (for yolov3 and yolov4: all but the stem)."""
    return _calls(convs, layers, 'k2')


def grouped_calls(convs, layers):
    """The convs that the int8 engine runs through ``grouped_conv_int8``
    (mobilenet's depthwise convs)."""
    return _calls(convs, layers, 'grouped')


def _int8_conv_bound_ms(conv, bs):
    """One int8 conv's bound for a batch: its int8 input, weights and f32
    bias read once, its int8 output written once, 2 operations a
    multiply-add at the int8 peak."""
    lyr, h_in, h_out, macs = conv
    n_bytes = (bs * h_in * h_in * lyr.cin
               + lyr.cout * lyr.size ** 2 * (lyr.cin // lyr.groups)
               + 4 * lyr.cout + bs * h_out * h_out * lyr.cout)
    return bound_ms(n_bytes, 2.0 * bs * macs, INT8_OPS_PER_S)


def _total_ms(calls, bs):
    # added one by one in order: Python's ``sum`` of floats compensates its
    # rounding and reads a few ulps off the figures kept so far
    total = 0.0
    for c in calls:
        total += _int8_conv_bound_ms(c, bs)
    return total


def k2_bound_ms(convs, layers, bs):
    """K2's bound for one batch: the sum of its convs' bounds."""
    return _total_ms(k2_calls(convs, layers), bs)


def grouped_bound_ms(convs, layers, bs):
    """The bound of the engine's grouped int8 convs for one batch, the
    same work whatever kernel runs them; None without any."""
    calls = grouped_calls(convs, layers)
    return _total_ms(calls, bs) if calls else None


def k1_bound_ms(bs, k, valid_per_image, overlapping_pairs=0):
    """K1's bound for one batch of ``bs`` images of ``k`` candidates: the
    class-offset and raw boxes, the scores and the valid flags read once,
    keep and the merged boxes written once; 14 f32 operations an IoU of a
    pair of valid candidates, 4 a valid row, 9 an overlapping pair of the
    merge."""
    n_bytes = bs * k * (16 + 16 + 4 + 1) + bs * k * (1 + 16)
    n_ops = sum(v * (v - 1) / 2 * 14 + v * 4 for v in valid_per_image)
    return bound_ms(n_bytes, n_ops + 9 * overlapping_pairs, F32_OPS_PER_S)
