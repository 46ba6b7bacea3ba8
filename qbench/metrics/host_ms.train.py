"""Host milliseconds a train step inside the program: the durations of
each traced step's root spans (``sampler.sample``, ``feature.lookup``,
``train.step``) on the host clock, summed, mean a step. Beside the
step's device time it says whether the host's dispatch paces the card.
Read from the program's span ring (``quiver_tpu_torch.tracing``): the
traced slice's steps are the first root spans of each name in it."""

ROOTS = ("sampler.sample", "feature.lookup", "train.step")


def read(s):
    from quiver_tpu_torch import tracing
    per_unit = getattr(tracing, "per_unit", None)
    if per_unit is None or not s.units:
        return None
    ms = [per_unit(r, s.units, field="host_ms") for r in ROOTS]
    return None if None in ms else sum(ms)
