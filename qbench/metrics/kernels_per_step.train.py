"""Kernels the device ran a train step: the profiler's kernel events in
the traced slice over its steps."""


def read(s):
    return s.kernel_count("") / s.units if s.units else None
