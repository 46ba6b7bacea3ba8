"""Device milliseconds a train step in the frontier's feature lookup:
the program's ``feature.lookup`` span of each traced step, timed by the
CUDA events it records, mean a step. Read from the program's span ring
(``quiver_tpu_torch.tracing``): the traced slice's steps are the first
``feature.lookup`` spans in it."""


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    return per_unit("feature.lookup", s.units)
