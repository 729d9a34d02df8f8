"""The tapped forward's share of the H100's bf16 peak in the traced window:
the model FLOPs of the window's sequences (``counts/nemotron_h_flops.py``)
over the window times 989 TFLOP/s, in %."""

from h100_bench.counts import PEAK_BF16_FLOPS, nemotron_h_flops


def read(run):
    c = run.counters
    if not c.get("batches") or run.window_s <= 0:
        return None
    flops = c["batches"] * c["batch"] * nemotron_h_flops.per_sequence(
        run.config["model"], c["seq_len"])
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
