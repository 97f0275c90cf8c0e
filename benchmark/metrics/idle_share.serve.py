"""The share of the traced stretch of serving in which no operation ran
on the device."""


def read(rec):
    if rec['driver'] != 'serve' or rec['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - rec['busy_s'] / rec['window_s'])
