"""Kernels the device ran a served batch: the profiler's kernel events in
the traced slice over its batches."""


def read(s):
    return s.kernel_count("") / s.units if s.units else None
