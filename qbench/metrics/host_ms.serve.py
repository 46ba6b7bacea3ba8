"""Host milliseconds a served batch inside the program: the duration of
each traced batch's ``serve.run`` span on the host clock, mean a batch.
Read from the program's span ring (``quiver_tpu_torch.tracing``): the
traced slice's batches are the first ``serve.run`` spans in it."""


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    return per_unit("serve.run", s.units, field="host_ms")
