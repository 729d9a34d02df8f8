"""The loop's ``rows_per_s`` (rows acknowledged in the window over the
window, host clock), read in the traced run, where the host paces it."""


def read(run):
    return run.window_metrics.get("rows_per_s")
