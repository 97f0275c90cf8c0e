"""K1's share of its roofline: its bound for a batch of ``top_k``
candidates an image, all valid (``counts.k1_bound_ms``), over K1's device
time a batch."""


def read(rec):
    t = rec['groups_s'].get('K1 nms_suppress', 0.0) / rec['steps']
    if rec.get('k1_bound_ms') is None or t <= 0:
        return None
    return 100.0 * rec['k1_bound_ms'] / 1e3 / t
