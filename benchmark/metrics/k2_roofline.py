"""K2's share of its roofline: the bound of the int8 engine's convs of a
batch (``counts.k2_bound_ms``) over K2's device time a batch."""


def read(rec):
    t = rec['groups_s'].get('K2 conv_int8', 0.0) / rec['steps']
    if rec.get('k2_bound_ms') is None or t <= 0:
        return None
    return 100.0 * rec['k2_bound_ms'] / 1e3 / t
