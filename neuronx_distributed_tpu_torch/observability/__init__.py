"""Serving observability (counterpart of
``neuronx_distributed_tpu/observability``): the metrics registry
(``registry.py``), SLO attainment and goodput (``slo.py``), request-scoped
tracing (``tracing.py``), the speculative acceptance recorder
(``spec_stats.py``), the flight recorder (``flight_recorder.py``), the
HBM ledger (``hbm.py``), the program ledger (``programs.py``), the
profiler window (``profiler.py``) and the trainer's ``MetricsCallback``
(``callback.py``)."""
