"""How uneven the routing is: per MoE layer, the most-loaded expert's
routed rows over the mean expert's, the largest over the layers, from the
program's tally of rows per (layer, expert) over the traced window
(``moe.expert_rows`` of ``repro_torch.tracing``); ``None`` without it."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    tally = getattr(tracing, "tallies", dict)().get("moe.expert_rows")
    if tally is None:
        return None
    rows = tally.to("cpu", copy=True).double()
    rows = rows[rows.sum(dim=1) > 0]
    if not rows.numel():
        return None
    return float((rows.max(dim=1).values / rows.mean(dim=1)).max())
