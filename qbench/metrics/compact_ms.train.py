"""Device milliseconds a train step in the sampler's compaction: the
program's ``sample.compact`` spans (one a hop) under each traced step's
``sampler.sample`` span, timed by the CUDA events the spans record,
summed over the hops, mean a step. Read from the program's span ring
(``quiver_tpu_torch.tracing``): the traced slice's steps are the first
``sampler.sample`` spans in it."""


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    return per_unit("sampler.sample", s.units, "sample.compact")
