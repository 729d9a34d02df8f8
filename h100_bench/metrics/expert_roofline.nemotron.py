"""The routed expert products' share of their roofline in the traced
window: the least time of the window's MoE layers' up and down products
(``counts/expert_bound.py``, ``batch * seq_len * experts_per_token`` rows a
layer) over the device time of the grouped product kernels
(``torch._grouped_mm``'s, named by :data:`KERNEL`), in %."""

from h100_bench.counts import expert_bound

KERNEL = "GroupProblemShape"  # CUTLASS's grouped GEMM on sm90


def read(run):
    us, _ = run.kernel_us(KERNEL)
    c, m = run.counters, run.config["model"]
    if not us or not c.get("batches"):
        return None
    rows = c["batch"] * c["seq_len"] * m["experts_per_token"]
    calls = c["batches"] * m["layer_pattern"].count("moe")
    bound = calls * expert_bound.bound_s(rows, m["d_model"], m["d_ff"],
                                         m["num_experts"])
    return 100.0 * bound / (us / 1e6)
