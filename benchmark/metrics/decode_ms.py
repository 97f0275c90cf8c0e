"""Device ms a serving batch in decode and the candidates' top-k: the
program's ``nms.decode`` spans under the device-only stretch's
``serve.infer`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'nms.decode' not in s or 'serve.infer' not in s:
        return None
    return 1e3 * s['nms.decode']['device_s'] / s['serve.infer']['count']
