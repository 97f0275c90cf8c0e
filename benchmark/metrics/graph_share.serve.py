"""The share of the int8 engine's serving calls that replayed a CUDA graph:
the program's always-on counter ``serve.graph_replays`` over all its
serving calls, eager (``serve.eager_calls``), captured
(``serve.graph_captures``) or replayed, over the whole run (set-up, window
and the traced stretch, which runs eagerly), in %.

None for a program without these counters, which counts none of them."""


def read(rec):
    try:
        from yolo_tpu_torch.utils.profiler import counter
    except ImportError:             # a program without counters
        return None
    if rec['driver'] != 'serve':
        return None
    calls = {k: counter(f'serve.{k}')
             for k in ('eager_calls', 'graph_captures', 'graph_replays')}
    total = sum(calls.values())
    if not total:
        return None
    return 100.0 * calls['graph_replays'] / total
