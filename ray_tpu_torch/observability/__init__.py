"""ray_tpu_torch.observability — the port's copies of the metrics
registry, the in-process timeline, tracing and the SLO ledger that the
serving engine reports through (``ray_tpu.observability``)."""
