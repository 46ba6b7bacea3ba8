"""The share of the traced slice in which no kernel, copy or fill ran
on the device: one less the union of their intervals over the slice's
length on the host clock."""


def read(s):
    if s.window_s <= 0 or not s.device:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s)
