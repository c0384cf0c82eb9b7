"""The port's observability store: ``registry`` (counters, gauges,
histograms, meters; a copy of the JAX package's standard-library module of
the same name) and ``trace`` (the span and instant call sites, off until
ROADMAP Queue 1 item 13 brings the tracer). The serving layer and the run
loop write to them; ``serve/metrics.py`` reads the registry."""
