"""The whole serving step's share of the chip's peak for the served
precision: the conv operations of a batch over the window's time a
batch."""


def read(rec):
    if rec['driver'] != 'serve':
        return None
    return 100.0 * rec['conv_ops'] / rec['window_step_s'] / rec['peak_ops_per_s']
