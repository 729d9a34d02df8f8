"""Activation-sharding hints (port of ``repro.sharding.constraints``).

``hint(x, name)`` marks a point of the model where the launcher's rule for
``name`` (``specs.activation_hint_rules``) pins an activation's layout. In
the reference it is ``jax.lax.with_sharding_constraint``: a layout, not a
value. The port's single controller keeps activations whole on one device,
so ``hint`` returns ``x`` itself; with a rule installed it still checks the
rule against the ambient mesh (``mesh.set_mesh``) and raises on an axis the
mesh lacks, as the reference's constraint does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch

from repro_torch.sharding.mesh import get_mesh
from repro_torch.sharding.specs import PartitionSpec

_state = threading.local()


def _rules() -> Dict[str, PartitionSpec]:
    return getattr(_state, "rules", {})


@contextlib.contextmanager
def activation_rules(rules: Optional[Dict[str, PartitionSpec]]
                     ) -> Iterator[None]:
    """Install named activation rules for the enclosed code (this
    thread)."""
    prev = _rules()
    _state.rules = dict(rules or {})
    try:
        yield
    finally:
        _state.rules = prev


def hint(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` itself; raises if the rule installed for ``name`` names an
    axis the ambient mesh lacks, or there is no ambient mesh."""
    spec = _rules().get(name)
    if spec is None:
        return x
    mesh = get_mesh()
    named = [a for d in range(len(spec)) for a in spec.axes(d)]
    if mesh is None:
        raise ValueError(f"a sharding rule for {name!r} needs an ambient "
                         f"mesh (sharding.mesh.set_mesh)")
    missing = [a for a in named if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"the rule for {name!r} ({spec}) names axes "
                         f"{missing} the mesh {mesh.axis_names} lacks")
    return x
