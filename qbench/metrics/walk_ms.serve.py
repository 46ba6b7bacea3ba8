"""Device milliseconds a served batch in the fused walk: the program's
``serve.walk`` span under each traced batch's ``serve.run`` span, timed
by the CUDA events it records, mean a batch. Read from the program's
span ring (``quiver_tpu_torch.tracing``): the traced slice's batches are
the first ``serve.run`` spans in it."""


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    return per_unit("serve.run", s.units, "serve.walk")
