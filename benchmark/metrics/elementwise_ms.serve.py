"""Device ms a serving batch in elementwise and reduction kernels: the
int8 engine's requant chains, the float forward's bias and activation
passes."""


def read(rec):
    if rec['driver'] != 'serve':
        return None
    g = rec['groups_s']
    return 1e3 * (g.get('elementwise', 0.0) + g.get('reduce', 0.0)) / rec['steps']
