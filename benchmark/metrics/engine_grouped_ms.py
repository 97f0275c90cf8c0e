"""Device ms a serving batch in the int8 engine's grouped int8 convs: the
program's ``engine.grouped`` spans (``grouped_conv_int8``, the convs K2
does not take, such as depthwise ones), inside its ``engine.conv`` spans,
under the device-only stretch's ``serve.infer`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'engine.grouped' not in s or 'serve.infer' not in s:
        return None
    return 1e3 * s['engine.grouped']['device_s'] / s['serve.infer']['count']
