"""The share of K1's candidate slots that hold a valid candidate: the
program's counters ``nms.valid`` over ``nms.slots`` in the device-only
stretch's ``serve.infer`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    c = summary(first=rec['steps'])['counters']
    if not c.get('nms.slots'):
        return None
    return 100.0 * c.get('nms.valid', 0) / c['nms.slots']
