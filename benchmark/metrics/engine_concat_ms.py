"""Device ms a serving batch in the int8 engine's multi-route concats: the
program's ``engine.concat`` spans (each part requantized to the common
scale, then the cat) under the device-only stretch's ``serve.infer``
spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'engine.conv' not in s or 'serve.infer' not in s:
        return None
    # the engine ran: a network without a multi-route concat spends 0 ms there
    t = s.get('engine.concat', {'device_s': 0.0})['device_s']
    return 1e3 * t / s['serve.infer']['count']
