"""Host us a kernel launch of serving: the host time of the program's
``serve.infer`` spans a batch over the kernels a batch, both of the
device-only stretch (the profiler's own cost a launch included)."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'serve.infer' not in s or not rec.get('kernels'):
        return None
    host_ms = 1e3 * s['serve.infer']['host_s'] / s['serve.infer']['count']
    return 1e3 * host_ms / (rec['kernels'] / rec['steps'])
