"""Kernel launches a train step, from the trace."""


def read(rec):
    if rec['driver'] != 'train':
        return None
    return rec['kernels'] / rec['steps']
