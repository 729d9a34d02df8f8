"""Serving: the STORM gateway and its tiered store (port of ``repro.serve``)."""
