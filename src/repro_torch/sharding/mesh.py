"""Device meshes and the shard arithmetic over them (the port's counterpart
of ``jax.sharding.Mesh``, ``jax.set_mesh``, ``repro.compat.shard_map`` and
``repro.launch.mesh.make_debug_mesh``).

Every mesh path of the reference is single-controller: one Python process
drives all of a host's devices through ``shard_map``, and reads every
shard's result itself. The port keeps that design. A :class:`Mesh` is a
row-major grid of ``torch.device`` under named axes, as
``np.array(devices).reshape(shape)`` lays them out; most paths take a
one-axis mesh. :func:`split` cuts a leading axis into contiguous equal
blocks, one per shard (the ``P(axis)`` layout), each moved to its shard's
device; :func:`shard_map` runs a body once per shard, in shard order, in
the calling thread; :func:`psum` is the merge, an exact int32 sum of the
shards' parts on the mesh's first device, and :func:`gather` concatenates
per-shard outputs there (``out_specs=P(axis)``). There are no process
groups. :func:`set_mesh` makes a mesh ambient for the code it encloses
(the sequence-parallel recurrence reads it), as ``jax.set_mesh`` does.
Every copy between shards that a collective would make on a mesh of
distinct devices is reported to the listeners of :func:`note_transfer`
(``launch.op_analysis`` counts them), also where two shards share a card.

A device may repeat: ``Mesh(("cuda:0",) * 4)`` puts four shards on one
card, the counterpart of the reference's forced host devices
(``--xla_force_host_platform_device_count``): every shard's arithmetic and
launches run, on one card. CPU meshes are built only from devices the
caller names ``"cpu"``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Union)

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class Mesh:
    """A row-major grid of devices (repeats allowed) under named axes.

    ``axis`` is one name, or a tuple of names with ``shape`` their extents
    (major first): device ``i`` of ``devices`` sits at the coordinates of
    ``i`` in that grid. A one-axis mesh needs no ``shape``."""

    def __init__(self, devices: Sequence[DeviceLike],
                 axis: Union[str, Sequence[str]] = "data",
                 shape: Optional[Sequence[int]] = None):
        devs = []
        for d in devices:
            if d is None:
                raise ValueError("name every device of a mesh")
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh's devices must be all cuda or all cpu; "
                             f"got {[str(d) for d in devs]}")
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if not names or len(set(names)) != len(names):
            raise ValueError(f"a mesh needs distinct axis names; got {names}")
        if shape is None:
            if len(names) != 1:
                raise ValueError(f"a mesh of axes {names} needs their shape")
            shape = (len(devs),)
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(names) or math.prod(shape) != len(devs):
            raise ValueError(f"{len(devs)} devices do not fill a grid of "
                             f"shape {shape} over axes {names}")
        self.devices = tuple(devs)
        self.axis_names = names
        self.grid = shape

    @property
    def axis(self) -> str:
        """The name of a one-axis mesh's axis (raises on a grid)."""
        if len(self.axis_names) != 1:
            raise ValueError(f"this path takes a one-axis mesh; the mesh has "
                             f"axes {self.axis_names}")
        return self.axis_names[0]

    @property
    def size(self) -> int:
        """The number of shards (devices, repeats counted)."""
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def first(self) -> torch.device:
        """Where merged and gathered results live."""
        return self.devices[0]

    def coords(self, i: int) -> Dict[str, int]:
        """Device ``i``'s coordinate on every axis (row-major)."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.grid)):
            i, out[name] = divmod(i, n)
        return {name: out[name] for name in self.axis_names}

    def index(self, coords: Dict[str, int]) -> int:
        """The position in ``devices`` of the device at ``coords`` (axes
        left out: coordinate 0)."""
        i = 0
        for name, n in zip(self.axis_names, self.grid):
            c = coords.get(name, 0)
            if not 0 <= c < n:
                raise IndexError(f"coordinate {c} out of range for axis "
                                 f"{name!r} of size {n}")
            i = i * n + c
        return i

    def along(self, axis: str, at: int = 0) -> List[torch.device]:
        """The devices along ``axis``, in its order, at the other axes'
        coordinates of device ``at`` (the first device's by default)."""
        if axis not in self.axis_names:
            raise KeyError(axis)
        fixed = self.coords(at)
        return [self.devices[self.index({**fixed, axis: c})]
                for c in range(self.shape[axis])]

    def __repr__(self) -> str:
        if len(self.axis_names) == 1:
            return (f"Mesh({[str(d) for d in self.devices]}, "
                    f"axis={self.axis!r})")
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names!r}, shape={self.grid})")


_ambient = threading.local()


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the ambient mesh of the enclosed code in this thread
    (the counterpart of ``jax.set_mesh``); the previous one comes back on
    exit."""
    prev = getattr(_ambient, "mesh", None)
    _ambient.mesh = mesh
    try:
        yield mesh
    finally:
        _ambient.mesh = prev


def get_mesh() -> Optional[Mesh]:
    """The ambient mesh (:func:`set_mesh`), or ``None``."""
    return getattr(_ambient, "mesh", None)


def make_debug_mesh(devices: Optional[Sequence[DeviceLike]] = None,
                    axis: str = "data") -> Mesh:
    """Every visible card as one ``axis`` (raises without a card), or the
    ``devices`` named."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError("no CUDA device is available; name the mesh's "
                               "devices (e.g. ['cpu'] * 2) to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(devices, axis)


_transfer_listeners: List[Callable[[str, int], None]] = []


def add_transfer_listener(fn: Callable[[str, int], None]) -> None:
    """Call ``fn(kind, nbytes)`` for every transfer :func:`note_transfer`
    reports (``kind`` an XLA collective's name, e.g. ``"all-reduce"``)."""
    _transfer_listeners.append(fn)


def remove_transfer_listener(fn: Callable[[str, int], None]) -> None:
    _transfer_listeners.remove(fn)


def note_transfer(kind: str, tensors: Sequence[Tensor]) -> None:
    """Report that ``tensors`` cross from one shard to another as part of
    the collective ``kind``."""
    if _transfer_listeners:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        for fn in list(_transfer_listeners):
            fn(kind, nbytes)


def home_device(mesh: Optional[Mesh], device: DeviceLike) -> torch.device:
    """Where a mesh-aware entry point reads, merges and returns: ``device``
    resolved (``None``: the card), or with a mesh its first device, which
    ``device``, if given, must name."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and Mesh([device]).first != mesh.first:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh.first}")
    return mesh.first


def block_size(n: int, mesh: Mesh, what: str = "leading axis") -> int:
    """Rows per shard of an ``n``-long leading axis; raises unless the mesh
    divides it."""
    if n % mesh.size:
        raise ValueError(f"{what} of size {n} not divisible by mesh axis "
                         f"{mesh.axis!r} ({mesh.size} shards)")
    return n // mesh.size


def split(x: Tensor, mesh: Mesh, what: str = "leading axis") -> List[Tensor]:
    """``x``'s leading axis in contiguous equal blocks, block ``i`` on shard
    ``i``'s device (a view where it already lives there)."""
    b = block_size(x.shape[0], mesh, what)
    return [x[i * b:(i + 1) * b].to(dev) for i, dev in enumerate(mesh.devices)]


def shard_map(body: Callable, mesh: Mesh, *sharded: Tensor) -> list:
    """``body(device, *blocks)`` once per shard, in shard order; returns the
    per-shard outputs. Each tensor of ``sharded`` is :func:`split` over the
    mesh; the body moves what it replicates to ``device`` itself."""
    parts = [split(x, mesh) for x in sharded]
    return [body(dev, *(p[i] for p in parts))
            for i, dev in enumerate(mesh.devices)]


def psum(parts: Sequence[Tensor], mesh: Mesh) -> Tensor:
    """The shards' integer parts summed exactly in int32 on the mesh's first
    device (the merge of sketches: integer addition, wrapping as the
    reference's ``psum`` of int32 does)."""
    if len(parts) != mesh.size:
        raise ValueError(f"psum needs one part per shard ({mesh.size}); got "
                         f"{len(parts)}")
    for p in parts:
        if p.dtype.is_floating_point or p.dtype == torch.bool:
            raise ValueError(f"psum sums integer parts; got {p.dtype}")
    note_transfer("all-reduce", parts[1:])
    out = parts[0].to(mesh.first, torch.int32, copy=True)
    for p in parts[1:]:
        out += p.to(mesh.first, torch.int32)
    return out


def gather(parts: Sequence[Tensor], mesh: Mesh) -> Tensor:
    """Per-shard blocks concatenated in shard order on the mesh's first
    device (a leading-axis ``P(axis)`` output, read in one place)."""
    note_transfer("all-gather", parts[1:])
    return torch.cat([p.to(mesh.first) for p in parts])
