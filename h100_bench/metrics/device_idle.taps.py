"""The share of the traced window in which no kernel or copy ran on the
card (torch.profiler), in %."""


def read(run):
    window = run.window_s
    return 100.0 * (1.0 - run.busy_s / window) if window > 0 else None
