"""One reader per per-layer metric, ``<metric>.py`` with ``read(record)``.

``record`` is the traced run's: ``requests`` (each traced request's wall
seconds, ``timings`` and steps), ``traced`` (the profiled request: its
``window``, its profiler ``events`` as (name, on the device, start, end) in
seconds, the ``stages`` ranges of the harness, the attention entries'
``launches``, its ``steps``), ``attention`` (the cell's attention ``shape``:
rows, heads, joint tokens, head dim) and ``step_flop``. A reader returns a number, or
None when it finds nothing to read; the harness then leaves the metric out."""
