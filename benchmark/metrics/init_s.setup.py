"""Seconds of the port's seeded construction (``V2APipeline.__init__``'s
``init`` span, a child per module), from ``last_timings["since_init"]`` of
the window's first call; nothing where the pipeline does not report it."""


def read(run):
    records = run.window_records()
    since = records[0].timings.get("since_init") if records else None
    return since.get("init_s") if isinstance(since, dict) else None
