"""Device milliseconds a train step in the model's step: the program's
``train.step`` span (GraphSAGE forward, backward and Adam) of each
traced step, timed by the CUDA events it records, mean a step. Read
from the program's span ring (``quiver_tpu_torch.tracing``): the traced
slice's steps are the first ``train.step`` spans in it."""


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    return per_unit("train.step", s.units)
