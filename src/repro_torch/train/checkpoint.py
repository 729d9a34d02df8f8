"""Fault-tolerant checkpoints with dtype-elastic restore (port of
``repro.train.checkpoint``, same layout on disk).

  * **Atomic**: a checkpoint is written to ``step_N.tmp/`` and renamed to
    ``step_%010d`` — a crashed writer never corrupts the newest one.
  * **Verified**: every array file has its CRC32 in ``manifest.json``
    (``step``, ``arrays``, ``metadata``); restore checks them and falls back
    past a corrupt checkpoint to the previous intact one.
  * **Keep-k**: older checkpoints are removed; the newest ``keep`` stay.
  * **Elastic**: arrays are saved as host numpy at their logical shapes and
    restored onto each template leaf's device and dtype, or, with
    ``shardings``, placed onto a target mesh (``sharding.specs``), whatever
    the mesh that saved them: restore is elastic across topologies.

One ``.npy`` per leaf, named by the CRC32 of the leaf's path
(``tree.leaf_paths``: the port's ``blocks`` is a list, so names carry the
cycle's index). A bf16 leaf is stored as its 16-bit pattern (int16) under
manifest dtype ``"bfloat16"`` and read back bit for bit; numpy has no
bfloat16 of its own. A ``'<V2'`` file, which is how the reference's
``np.save`` writes an ml_dtypes bfloat16 array, reads back the same way
(``interop.read_jax_checkpoint`` reads the reference's directories).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import specs
from repro_torch.train import tree as tree_lib

_MANIFEST = "manifest.json"


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as a host array and its manifest dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's raw bytes (``zlib.crc32(arr.tobytes())``)."""
    return zlib.crc32(memoryview(np.require(arr, requirements="C")).cast("B"))


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded array as a CPU tensor of its manifest dtype: ``"bfloat16"``
    from its 16-bit pattern (int16, uint16 or ``'<V2'``), bit for bit."""
    if dtype_name == "bfloat16":
        bits = np.require(arr, requirements="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C"))


def save(directory: str, step: int, state: Any, keep: int = 3,
         extra_metadata: Optional[Dict[str, Any]] = None) -> str:
    """Atomically persist a tree of tensors. Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "arrays": {},
                                "metadata": extra_metadata or {}}
    for name, leaf in tree_lib.leaf_paths(state):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"{zlib.crc32(name.encode()):08x}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["arrays"][name] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "crc32": _crc(arr),
        }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for stale in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, stale))
    for tmp in (d for d in os.listdir(directory) if d.endswith(".tmp")):
        shutil.rmtree(os.path.join(directory, tmp))


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )


def _verify_and_load(path: str
                     ) -> Optional[Tuple[int, Dict[str, torch.Tensor],
                                         Dict[str, Any]]]:
    """``(step, {name: CPU tensor}, metadata)`` of one checkpoint directory,
    or ``None`` if it is missing, torn or fails a CRC."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        arrays = {}
        for name, meta in manifest["arrays"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            if _crc(arr) != meta["crc32"]:
                raise IOError(f"CRC mismatch for {name}")
            arrays[name] = _to_tensor(arr, meta["dtype"])
        return manifest["step"], arrays, manifest.get("metadata", {})
    except (OSError, ValueError, KeyError, TypeError, EOFError):
        return None


def newest_intact(directory: str):
    """:func:`_verify_and_load` of the newest intact checkpoint, or None."""
    for step in reversed(available_steps(directory)):
        loaded = _verify_and_load(
            os.path.join(directory, f"step_{step:010d}"))
        if loaded is not None:
            return loaded
    return None


def restore(directory: str, template: Any, shardings: Optional[Any] = None
            ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
    """Restore the newest intact checkpoint into ``template``'s structure.

    Each leaf comes back on its template leaf's device, cast to its dtype,
    and requiring gradients where the template leaf does (parameters stay
    trainable); ``None`` subtrees stay ``None``. ``template``'s leaves may
    be meta tensors (shapes and dtypes only).

    ``shardings``: a tree of ``sharding.specs.NamedSharding`` matching
    ``template`` (``specs.named(mesh, specs)``). A leaf it names is placed
    on that mesh by ``specs.device_put`` and comes back as a
    ``ShardedTensor`` in the template's dtype: one block per device.

    Returns:
      ``(step, state, metadata)``, or ``None`` if no intact checkpoint
      exists.
    """
    loaded = newest_intact(directory)
    if loaded is None:
        return None
    step, arrays, metadata = loaded
    placed = ({} if shardings is None
              else dict(tree_lib.leaf_paths(shardings)))

    def build(name: str, leaf: torch.Tensor):
        if name in placed:
            return specs.ShardedTensor(arrays[name].to(leaf.dtype),
                                       placed[name])
        out = arrays[name].to(device=leaf.device, dtype=leaf.dtype)
        return out.requires_grad_(True) if leaf.requires_grad else out

    return step, tree_lib.map_with_path(build, template), metadata
