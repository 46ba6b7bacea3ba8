"""The operator CLIs over the port's JSONL sinks (counterparts of the
JAX package's ``scripts/qt_top.py``, ``qt_agg.py``, ``qt_trace.py`` and
``qt_capacity.py``; the same flags, defaults and output text).

Each runs as ``python -m quiver_tpu_torch.scripts.<name>``:

- ``qt_top``: a live ANSI dashboard over one ``MetricsSink`` file
  (``--fleet``: the aggregator's fleet panel). Standard library only.
- ``qt_trace``: search, inspect and export tail-sampled traces.
  Standard library only: the port's ``tailsampling`` and ``tracing``
  load without the package.
- ``qt_agg``: the fleet aggregator and its ``/metrics`` and
  ``/healthz`` endpoint over replica sinks. It imports torch but never
  touches the card, so it runs beside a replica that holds it.
- ``qt_capacity``: the newest ``capacity`` record, or a fresh
  prediction from observed ``serving`` records (``--predict``) with the
  machine probe on the card (``--device``) unless ``--no-probe``.

The default ``--jsonl`` comes from ``QT_METRICS_JSONL``.
"""
