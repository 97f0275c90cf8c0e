"""The grouped int8 convs' share of their roofline: their bound for a
batch (``counts.grouped_bound_ms``: the work the engine hands
``grouped_conv_int8``, whatever kernel does it) over the device ms a batch
of the program's ``engine.grouped`` spans.

A span's device time is that of CUDA events around the call, so it holds
the device's waits for the host inside the span too: this share is at
most the kernels' own share of the same bound, and stays under 100%.
None without a bound (no grouped conv), without the spans, or where the
program counted no call (``grouped.calls``)."""


def read(rec):
    bound = rec.get('grouped_bound_ms')
    if bound is None:
        return None
    try:
        from yolo_tpu_torch.utils.profiler import summary
    except ImportError:             # a program without spans
        return None
    got = summary(first=rec['steps'])
    s = got['spans']
    if (not got['counters'].get('grouped.calls')
            or 'engine.grouped' not in s or 'serve.infer' not in s):
        return None
    ms = 1e3 * s['engine.grouped']['device_s'] / s['serve.infer']['count']
    return 100.0 * bound / ms if ms > 0 else None
