"""Static model profiling: params / MACs / GFLOPs from the IR (the port's
copy of ``yolo_tpu/utils/profiling.py``, numpy only).

Exact static analysis over the graph, no forward pass: the counts behind
``python -m yolo_tpu_torch.info``, the prune report and EagleEye's MACs
gate (``compress/prune_drivers.py``).
"""

from __future__ import annotations

from ..ir import NetworkIR


def count_params(net: NetworkIR) -> int:
    total = 0
    for lyr in net.layers:
        if lyr.kind in ('conv', 'depthwise'):
            in_per_group = lyr.in_channels // lyr.groups
            total += lyr.size * lyr.size * in_per_group * lyr.filters
            total += lyr.filters * (2 if lyr.bn else 1)     # gamma+beta | bias
            if lyr.bn:
                total += 2 * lyr.filters                     # running stats
        elif lyr.kind == 'batchnorm':
            total += 4 * lyr.filters
        elif lyr.kind == 'se':
            c, r = lyr.filters, lyr.reduction
            total += 2 * c * (c // r)
        elif lyr.kind == 'shortcut' and lyr.weighted:
            total += len(lyr.layers) + 1
    return total


def count_macs(net: NetworkIR, img_size=(416, 416)) -> int:
    """Multiply-accumulate count of one forward pass (thop convention:
    macs = flops / 2; conv MACs = H_out * W_out * k^2 * Cin/g * Cout)."""
    h, w = (img_size, img_size) if isinstance(img_size, int) else img_size
    total = 0
    sizes: list[tuple[int, int]] = []
    cur = (h, w)
    for lyr in net.layers:
        if lyr.kind in ('conv', 'depthwise'):
            sy, sx = lyr.stride_xy or (lyr.stride, lyr.stride)
            oh = (cur[0] + 2 * lyr.pad - lyr.size) // sy + 1
            ow = (cur[1] + 2 * lyr.pad - lyr.size) // sx + 1
            in_per_group = lyr.in_channels // lyr.groups
            total += oh * ow * lyr.size * lyr.size * in_per_group * lyr.filters
            cur = (oh, ow)
        elif lyr.kind == 'maxpool':
            if not (lyr.size == 2 and lyr.stride == 1):
                p = (lyr.size - 1) // 2
                cur = ((cur[0] + 2 * p - lyr.size) // lyr.stride + 1,
                       (cur[1] + 2 * p - lyr.size) // lyr.stride + 1)
        elif lyr.kind == 'upsample':
            cur = (cur[0] * lyr.stride, cur[1] * lyr.stride)
        elif lyr.kind == 'reorg3d':
            cur = (cur[0] // lyr.stride, cur[1] // lyr.stride)
        elif lyr.kind in ('route', 'scale_channels'):
            if lyr.layers and lyr.layers[0] < len(sizes):
                cur = sizes[lyr.layers[0]]
        elif lyr.kind == 'avgpool':
            cur = (1, 1)
        elif lyr.kind == 'se':
            c, r = lyr.filters, lyr.reduction
            total += 2 * c * (c // r)
        sizes.append(cur)
    return total


def model_info(net: NetworkIR, img_size=416) -> dict:
    p = count_params(net)
    macs = count_macs(net, img_size)
    return {'params': p, 'macs': macs, 'gflops': 2 * macs / 1e9,
            'layers': len(net.layers)}
