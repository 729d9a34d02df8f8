"""Distributed STORM: shard-local sketching, the merge, and fleet training
on a device mesh (port of ``repro.core.distributed``).

The sketch's mergeability by addition is the paper's distributed claim:
each shard folds its stream into a private sketch, and one integer sum
gives the sketch of the union. Meshes are single-controller, as every mesh
path of the reference is (``repro_torch.sharding.mesh``): one process runs
each shard's work in shard order and merges on the mesh's first device.

* :func:`sharded_sketch`: per-shard builds of a stream split over a mesh
  axis, merged by an exact int32 sum (the reference's ``psum``).
* :func:`tree_merge`: pairwise merge of independently built sketches (the
  edge-gateway topology).
* :func:`fleet_fit`: a fleet of optimizers split over the mesh against ONE
  replicated sketch; counters are read-only, so no shard talks to another
  after the merge.
* :func:`fleet_fit_banked`: a tenant bank split over the mesh, each shard
  training exactly its tenants' fleet members.
* :func:`replicated_query`: the sketch loss on the merged sketch.

The fleet fits take the draws ``erm.fit`` and ``fleet.run_fleet`` take
(``directions``, ``refine_samples`` or a ``generator``) in place of the
reference's threefry keys. They are drawn once for the whole fleet and
sliced per shard, so a fit's result does not depend on the shard count:
``mesh=None`` and every mesh give the same bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import dfo, erm, lsh, sketch as sketch_lib
from repro_torch.device import randn
from repro_torch.sharding import mesh as mesh_lib
from repro_torch.sharding import specs
from repro_torch.sharding.mesh import Mesh

Tensor = torch.Tensor


def sharded_sketch(
    params: lsh.LSHParams,
    z: Tensor,
    mesh: Mesh,
    axis: str = "data",
    paired: bool = True,
    batch: int = 256,
    engine: str = "auto",
) -> sketch_lib.Sketch:
    """Build one merged sketch from a stream split over ``axis``.

    Each shard sketches its contiguous block of ``z`` on its device with
    ``sketch.sketch_dataset`` (on the card one insert launch per shard,
    paired or single-sided), and the int32 counts and
    ``n`` are summed on the mesh's first device, where the merged sketch
    lives. ``z``'s length must be a multiple of the shard count.
    """
    if axis != mesh.axis:
        raise KeyError(axis)  # an axis the mesh lacks, as in JAX
    parts = mesh_lib.shard_map(
        lambda dev, zb: sketch_lib.sketch_dataset(
            params, zb, batch=batch, paired=paired, engine=engine,
            device=dev),
        mesh, z)
    return sketch_lib.Sketch(
        counts=mesh_lib.psum([p.counts for p in parts], mesh),
        n=mesh_lib.psum([p.n for p in parts], mesh))


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


def _fleet_draws(config: dfo.DFOConfig, f: int, dim: int, refine_steps: int,
                 directions: Optional[Tensor],
                 refine_samples: Optional[Tensor],
                 generator: Optional[torch.Generator], device
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """The whole fleet's draws, in ``fleet.run_fleet``'s order (the sphere
    directions, then one ``(F, m, dim)`` block per refine pass), so a
    meshless fit from ``generator`` equals ``run_fleet`` from it."""
    if directions is None:
        if generator is None:
            raise ValueError("fleet fits need directions or a generator")
        directions = dfo.sphere_directions(generator, config.steps, f,
                                           config.num_queries, dim, device)
    if refine_steps and refine_samples is None:
        if generator is None:
            raise ValueError("fleet fits need refine_samples or a generator")
        m = dfo.refine_sample_count(dim)
        refine_samples = torch.stack([randn((f, m, dim), generator, device)
                                      for _ in range(refine_steps)])
    return directions, (refine_samples if refine_steps else None)


def _member_blocks(x: Optional[Tensor], spec: specs.PartitionSpec,
                   mesh: Mesh) -> list:
    """Draws ``(passes, F, ...)`` split on their member axis (the second)."""
    if x is None:
        return [None] * mesh.size
    return [b.transpose(0, 1).contiguous()
            for b in specs.place(x.transpose(0, 1), spec, mesh)]


def _run_sharded(local, mesh: Optional[Mesh], spec, device, theta0: Tensor,
                 sig: Tensor, lr: Tensor, dirs: Tensor,
                 refine: Optional[Tensor], *bank: Tensor
                 ) -> dfo.FleetDFOResult:
    """``local(device, *bank_blocks, theta0, sigma, lr, directions, refine)``
    on ``device`` (``mesh=None``) or once per shard over its blocks; the
    per-shard iterates and traces are gathered in member order."""
    if mesh is None:
        theta, losses = local(device, *bank, theta0.to(device), sig, lr,
                              dirs, refine)
        return dfo.FleetDFOResult(theta=theta, losses=losses)
    cols = [specs.place(x, spec, mesh) for x in (*bank, theta0, sig, lr)]
    cols += [_member_blocks(dirs, spec, mesh),
             _member_blocks(refine, spec, mesh)]
    outs = [local(dev, *(c[i] for c in cols))
            for i, dev in enumerate(mesh.devices)]
    return dfo.FleetDFOResult(
        theta=mesh_lib.gather([o[0] for o in outs], mesh),
        losses=mesh_lib.gather([o[1] for o in outs], mesh))


def fleet_fit(
    sk: sketch_lib.Sketch,
    params: lsh.LSHParams,
    theta0: Tensor,
    config: dfo.DFOConfig,
    mesh: Optional[Mesh] = None,
    axis: str = "fleet",
    sigma: Optional[Union[float, Tensor]] = None,
    learning_rate: Optional[Union[float, Tensor]] = None,
    refine_steps: int = 0,
    refine_radius: float = 0.3,
    l2: float = 0.0,
    engine: str = "auto",
    project_last: bool = True,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> dfo.FleetDFOResult:
    """Train F models against ONE replicated sketch, the fleet over the mesh.

    The sketch and the hash family replicate to every shard's device; shard
    ``i`` advances its block of members with ``fleet.run_fleet`` through
    ``erm.sketch_loss_fn`` (on the card one query launch per DFO step per
    shard) and no collective.

    Args:
      sk: the merged sketch.
      params: the hash family.
      theta0: ``(F, dim)`` initial iterates.
      config: shared DFO hyperparameters.
      mesh: device mesh; ``None`` runs the same program on ``sk``'s device.
      axis: mesh axis carrying the fleet shards.
      sigma / learning_rate: optional per-member ``(F,)`` hyperparameters.
      refine_steps / refine_radius: optional quadratic-polish passes.
      l2: ridge on the sketch loss.
      engine: query path (``scan | kernel | auto``).
      project_last: pin ``theta[..., -1] = -1`` (Algorithm 2's constraint).
      directions: ``(steps, F, k, dim)`` unit directions; refine_samples:
        ``(refine_steps, F, m, dim)``; drawn from ``generator`` when
        omitted, once for the whole fleet.

    Returns:
      ``FleetDFOResult`` with ``(F, dim)`` thetas and ``(F, steps)`` traces,
      on ``sk``'s device (``mesh=None``) or the mesh's first device.
    """
    f, dim = theta0.shape
    device = sk.counts.device if mesh is None else mesh.first
    proj = dfo.pin_last_coordinate(-1.0) if project_last else None
    sig = dfo._fleet_param(sigma, config.sigma, f, device)
    lr = dfo._fleet_param(learning_rate, config.learning_rate, f, device)
    dirs, refine = _fleet_draws(config, f, dim, refine_steps, directions,
                                refine_samples, generator, device)
    fleet_spec, _ = specs.fleet_specs(axis)
    if mesh is not None:
        specs.check_fleet_divisible(f, mesh, axis)

    def local(dev, th, sg, lr_, dirs_, refine_):
        loss_fn = erm.sketch_loss_fn(
            sketch_lib.Sketch(counts=sk.counts.to(dev), n=sk.n.to(dev)),
            lsh.LSHParams(projections=params.projections.to(dev)),
            paired=True, l2=l2, engine=engine)
        res = erm.run_fleet(
            loss_fn, th, config, project=proj, sigma=sg, learning_rate=lr_,
            refine_steps=refine_steps, refine_radius=refine_radius,
            directions=dirs_, refine_samples=refine_)
        return res.theta, res.losses

    return _run_sharded(local, mesh, fleet_spec, device, theta0, sig, lr,
                        dirs, refine)


def fleet_fit_banked(
    bank: sketch_lib.SketchBank,
    params: lsh.LSHParams,
    theta0: Tensor,
    config: dfo.DFOConfig,
    restarts_per_sketch: int,
    mesh: Optional[Mesh] = None,
    axis: str = "bank",
    sigma: Optional[Union[float, Tensor]] = None,
    learning_rate: Optional[Union[float, Tensor]] = None,
    refine_steps: int = 0,
    refine_radius: float = 0.3,
    l2: float = 0.0,
    engine: str = "auto",
    paired: bool = True,
    scale: float = 1.0,
    project_last: bool = True,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> dfo.FleetDFOResult:
    """Train S tenants x F restarts with the bank axis split over a mesh.

    Each shard owns a contiguous block of the bank and exactly the fleet
    members of those tenants (``sharding.specs.bank_specs``), with the
    member map ``repeat(arange(S_local), F)``, a pure reindex of the global
    one: on the card one banked query launch per DFO step per shard, and no
    shard reads another's tables.

    Args:
      bank: the sketch bank ``(S, R, B)``.
      params: the shared hash family.
      theta0: ``(S*F, dim)`` member-major initial iterates (tenant t's F
        members at rows ``[t*F, (t+1)*F)``, ``fleet.seed_fleet_many``'s
        layout).
      config: shared DFO hyperparameters.
      restarts_per_sketch: F, members per tenant.
      mesh: device mesh; ``None`` runs the same program on the bank's
        device.
      axis: mesh axis carrying the bank shards.
      sigma / learning_rate: optional per-member ``(S*F,)`` hyperparameters.
      refine_steps / refine_radius / l2 / engine: as :func:`fleet_fit`.
      paired / scale: the estimator (PRP regression and probes, or the
        single-sided ``2**p``-scaled margin).
      project_last: pin ``theta[..., -1] = -1``.
      directions / refine_samples / generator: as :func:`fleet_fit`, over
        all ``S*F`` members.

    Returns:
      ``FleetDFOResult`` with ``(S*F, dim)`` thetas and traces.
    """
    s = bank.n.shape[0]
    f_total, dim = theta0.shape
    if f_total != s * restarts_per_sketch:
        raise ValueError(
            f"theta0 carries {f_total} members for {s} sketches x "
            f"{restarts_per_sketch} restarts"
        )
    device = bank.counts.device if mesh is None else mesh.first
    proj = dfo.pin_last_coordinate(-1.0) if project_last else None
    sig = dfo._fleet_param(sigma, config.sigma, f_total, device)
    lr = dfo._fleet_param(learning_rate, config.learning_rate, f_total,
                          device)
    dirs, refine = _fleet_draws(config, f_total, dim, refine_steps,
                                directions, refine_samples, generator, device)
    bank_spec, _ = specs.bank_specs(axis)
    if mesh is not None:
        specs.check_bank_divisible(s, mesh, axis)

    def local(dev, counts, n, th, sg, lr_, dirs_, refine_):
        s_local = counts.shape[0]
        member_map = torch.arange(s_local, dtype=torch.int32, device=dev)[
            :, None].expand(s_local, restarts_per_sketch).reshape(-1)
        loss_fn = erm.sketch_loss_fn(
            sketch_lib.SketchBank(counts=counts.to(dev), n=n.to(dev)),
            lsh.LSHParams(projections=params.projections.to(dev)),
            paired=paired, scale=scale, l2=l2, engine=engine,
            member_map=member_map)
        res = erm.run_fleet(
            loss_fn, th, config, project=proj, sigma=sg, learning_rate=lr_,
            refine_steps=refine_steps, refine_radius=refine_radius,
            directions=dirs_, refine_samples=refine_)
        return res.theta, res.losses

    return _run_sharded(local, mesh, bank_spec, device, theta0, sig, lr,
                        dirs, refine, bank.counts, bank.n)


def replicated_query(sk: sketch_lib.Sketch, params: lsh.LSHParams,
                     thetas: Tensor, paired: bool = True,
                     engine: str = "auto") -> Tensor:
    """The sketch loss at ``thetas`` on a merged sketch, where it lives (on
    the card one query launch)."""
    dev = sk.counts.device
    thetas = thetas.to(dev)
    params = lsh.LSHParams(projections=params.projections.to(dev))
    if sketch_lib.resolve_engine(engine, dev) == "kernel":
        from repro_torch.kernels import ops  # deferred: ops imports core

        return ops.query_theta(sk, params, thetas, paired=paired)
    return sketch_lib.query_theta(sk, params, thetas, paired=paired)
