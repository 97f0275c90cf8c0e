"""ms of ``grad_fn`` by CUDA events around the call, the median over the
window's steps."""
import statistics


def read(rec):
    t = rec.get('events_ms', {}).get('grad_fn')
    return statistics.median(t) if t else None
