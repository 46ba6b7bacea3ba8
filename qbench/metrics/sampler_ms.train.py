"""Milliseconds of a step in ``GraphSageSampler.sample``: CUDA events
the benchmark records around each call in the traced steps, mean a
step."""


def read(s):
    v = s.facts.get("sampler_ms")
    return float(v) if v else None
