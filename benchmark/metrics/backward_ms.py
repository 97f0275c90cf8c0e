"""Device ms a train step in the backward: the program's
``train.backward`` spans under the device-only stretch's ``train.grad``
spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'train.backward' not in s or 'train.grad' not in s:
        return None
    return 1e3 * s['train.backward']['device_s'] / s['train.grad']['count']
