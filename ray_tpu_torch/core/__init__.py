"""ray_tpu_torch.core — the port's copies of the runtime pieces its serving
path reads: ``config`` (the flags it uses), ``deadline`` and ``streaming``
(the stream item types)."""
