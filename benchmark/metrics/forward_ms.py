"""Device ms a train step in the forward: the program's ``train.forward``
spans under the device-only stretch's ``train.grad`` spans."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    s = summary(first=rec['steps'])['spans']
    if 'train.forward' not in s or 'train.grad' not in s:
        return None
    return 1e3 * s['train.forward']['device_s'] / s['train.grad']['count']
