"""Kernel launches a serving batch, from the trace."""


def read(rec):
    if rec['driver'] != 'serve':
        return None
    return rec['kernels'] / rec['steps']
