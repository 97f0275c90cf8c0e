"""The whole train step's share of the bf16 peak: three times the
forward's conv operations a step over the window's time a step."""


def read(rec):
    if rec['driver'] != 'train':
        return None
    return 100.0 * rec['conv_ops'] / rec['window_step_s'] / rec['peak_ops_per_s']
