"""Seconds of the sampler programs' eager warm-ups and captures in set-up
(``CapturedPrograms.captures``), from ``last_timings["since_init"]`` of the
window's first call; nothing where the pipeline does not report it."""


def read(run):
    records = run.window_records()
    since = records[0].timings.get("since_init") if records else None
    return since.get("capture_s") if isinstance(since, dict) else None
