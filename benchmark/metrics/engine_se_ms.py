"""Device ms a serving batch in the int8 engine's SE blocks: the
program's ``engine.se`` spans (each SE, global avgpool and scale_channels
layer, in f32) under the device-only stretch's ``serve.infer`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'engine.se' not in s or 'serve.infer' not in s:
        return None
    return 1e3 * s['engine.se']['device_s'] / s['serve.infer']['count']
