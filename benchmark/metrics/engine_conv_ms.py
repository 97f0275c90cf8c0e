"""Device ms a serving batch in the int8 engine's convs: the program's
``engine.conv`` spans (K2, the float stem, the grouped int8 conv and their
row prep) under the device-only stretch's ``serve.infer`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'engine.conv' not in s or 'serve.infer' not in s:
        return None
    return 1e3 * s['engine.conv']['device_s'] / s['serve.infer']['count']
