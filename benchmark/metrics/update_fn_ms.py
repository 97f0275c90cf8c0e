"""ms of ``update_fn`` by CUDA events around the call, the median over
the window's steps."""
import statistics


def read(rec):
    t = rec.get('events_ms', {}).get('update_fn')
    return statistics.median(t) if t else None
