"""Device ms a serving batch in the int8 engine's shortcuts: the program's
``engine.shortcut`` spans (the f32 requant chains) under the device-only
stretch's ``serve.infer`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'engine.conv' not in s or 'serve.infer' not in s:
        return None
    # the engine ran: a network without a shortcut spends 0 ms there
    t = s.get('engine.shortcut', {'device_s': 0.0})['device_s']
    return 1e3 * t / s['serve.infer']['count']
