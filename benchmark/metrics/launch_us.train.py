"""Host us a kernel launch of training: the host time of the program's
``train.grad`` and ``train.update`` spans a step over the kernels a step,
both of the device-only stretch (the profiler's own cost a launch
included)."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'train.grad' not in s or 'train.update' not in s \
            or not rec.get('kernels'):
        return None
    host_ms = 1e3 * (s['train.grad']['host_s'] + s['train.update']['host_s']) \
        / s['train.grad']['count']
    return 1e3 * host_ms / (rec['kernels'] / rec['steps'])
