"""The share of the grouped int8 convs that K4 ran: the program's counters
``k4.launches`` (the depthwise int8 kernel's launches) over
``grouped.calls`` (the convs the engine handed ``grouped_conv_int8``) in
the device-only stretch's ``serve.infer`` spans, in %.

None where no grouped call was counted, and for a program without K4
(``yolo_tpu_torch.ops.depthwise_int8`` absent), which counts no launch."""

import importlib.util


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    if importlib.util.find_spec('yolo_tpu_torch.ops.depthwise_int8') is None:
        return None
    c = summary(first=rec['steps'])['counters']
    if not c.get('grouped.calls'):
        return None
    return 100.0 * c.get('k4.launches', 0) / c['grouped.calls']
