"""Rows a served batch read from the pinned host tier: the ``host_rows``
counter of the program's ``feature.lookup`` span under each traced
batch's ``serve.run`` span (the live distinct cold rows, or every cold
slot when the distinct rows overflow the dedup budget), mean a batch.
Read from the program's span ring (``quiver_tpu_torch.tracing``): the
traced slice's batches are the first ``serve.run`` spans in it."""


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    return per_unit("serve.run", s.units, "feature.lookup", "host_rows")
