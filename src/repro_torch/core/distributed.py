"""Sketch merging across shards (port of ``repro.core.distributed.tree_merge``;
the collective and sharded paths are not ported yet)."""

from __future__ import annotations

from typing import Sequence

from repro_torch.core import sketch as sketch_lib


def tree_merge(sketches: Sequence[sketch_lib.Sketch]) -> sketch_lib.Sketch:
    """Pairwise (associative) merge: the edge-gateway aggregation topology."""
    layer = list(sketches)
    if not layer:
        raise ValueError("tree_merge needs at least one sketch")
    while len(layer) > 1:
        nxt = [sketch_lib.merge(layer[i], layer[i + 1])
               for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]
