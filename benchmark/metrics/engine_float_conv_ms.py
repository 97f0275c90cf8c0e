"""Device ms a serving batch in the int8 engine's convs on a float edge:
the program's ``engine.float_conv`` spans (``float_edge_conv``: the stem,
and each conv after an SE, avgpool or scale_channels layer), inside its
``engine.conv`` spans, under the device-only stretch's ``serve.infer``
spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'engine.float_conv' not in s or 'serve.infer' not in s:
        return None
    return (1e3 * s['engine.float_conv']['device_s']
            / s['serve.infer']['count'])
