"""Device milliseconds a served batch in the cold fixup: the program's
``serve.cold_fixup`` span (the tiered lookup of the frontier's cold
slots: dedup, host-tier gather, overlay) under each traced batch's
``serve.run`` span, timed by the CUDA events it records, mean a batch.
Read from the program's span ring (``quiver_tpu_torch.tracing``): the
traced slice's batches are the first ``serve.run`` spans in it."""


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    return per_unit("serve.run", s.units, "serve.cold_fixup")
