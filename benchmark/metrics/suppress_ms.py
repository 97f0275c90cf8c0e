"""Device ms a serving batch in suppression: the program's
``nms.suppress`` spans (the candidate pairs, K1 and the ranking into the
output slots) under the device-only stretch's ``serve.infer`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'nms.suppress' not in s or 'serve.infer' not in s:
        return None
    return 1e3 * s['nms.suppress']['device_s'] / s['serve.infer']['count']
