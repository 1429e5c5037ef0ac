"""Fault-tolerant checkpointing: atomic commits, manifests, restore.

The reference's layout, per step::

    <dir>/step_000123/
        shard_<host>.npz      flat {path -> array} for host-local data
        manifest.json         descriptor-style records per array:
                              (name, shape, dtype, shard, offset=0, length)
        COMMIT                completion flag written last (the paper's
                              all-ones writeback, §II-D, as a filesystem rite)

Restores ignore step dirs without COMMIT (torn writes from preempted hosts),
and a save over one replaces it; a save of a step already committed writes
nothing (the reference writes it beside and keeps the committed arrays).
``keep`` bounds the committed steps kept. Saves run on a background thread
(training continues) but are serialized. Paths name leaves as the
reference's do (:mod:`repro_torch.tree`), and bfloat16 leaves go to the npz
as their raw 2-byte void view with the manifest dtype ``"bfloat16"``, as the
reference's do, so a checkpoint of a nested dict written by either package
restores in the other. ``restore`` rebuilds the tree of ``like`` on
``device``.

On a mesh backed by process groups (``launch.mesh.make_process_mesh``),
``save(..., mesh=, specs=)`` takes each rank's blocks of a tree under a
spec tree (``distributed.sharding.train_state_block_specs``), gathers
them to rank 0, which lays them into whole leaves and alone writes the
layout above, unchanged; the other ranks wait for its ``COMMIT``. A leaf
whose spec owns an axis (a pod's error-feedback residual) is written once
per position along it: position 0 under its own name, so that the other
package reads it, position ``i`` under ``<name>@<axis><i>``.
``restore(..., mesh=, specs=)`` gives each rank its block of every leaf:
the counterpart of the reference's ``shardings=`` (elastic re-mesh), onto
any mesh whose axes divide the leaves.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, map_with_path


def _own_name(path: str, axis: str, i: int) -> str:
    """The name of position ``i``'s copy of a leaf owned along ``axis``."""
    return path if i == 0 else f"{path}@{axis}{i}"


def _host_array(x) -> np.ndarray:
    """A leaf as a numpy array on the host: bfloat16 as raw 2-byte void. A
    copy, also of a CPU tensor: the save writes it on a thread while the
    next step updates the tree in place."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype.kind == "V" else str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             extra: Optional[Dict] = None, mesh=None,
             specs: Any = None) -> None:
        """Write ``tree`` as step ``step``: its leaves whole, or on a process
        ``mesh`` its blocks under ``specs``, gathered to rank 0 (blocking;
        every rank calls it)."""
        if mesh is not None:
            return self._save_blocks(step, tree, extra, mesh, specs)
        # Copy to the host *now* (the step may update the tree in place),
        # write async.
        self.wait()
        if self._committed(step):
            # The trainer's final save after a periodic one of the same
            # step: the committed arrays stay, as in the reference, and
            # nothing is copied or written again.
            self._gc()
            return
        flat = {k: _host_array(v) for k, v in flatten(tree).items()}
        t = threading.Thread(target=self._write, args=(step, flat, extra),
                             daemon=True)
        self._pending = t
        t.start()
        if blocking:
            self.wait()

    def _save_blocks(self, step: int, tree: Any, extra: Optional[Dict],
                     mesh, specs: Any) -> None:
        import torch.distributed as dist
        from repro_torch.distributed import sharding, shardlib
        self.wait()
        spec_of = flatten(specs)
        flat: Dict[str, np.ndarray] = {}
        done = self._committed(step)
        for path, block in flatten(tree).items():
            if done:
                break
            blocks = shardlib.gather_to_first(block, mesh)
            if blocks is None:
                continue
            spec = spec_of[path]
            whole = sharding.assemble(
                blocks, sharding.leaf_shape(block.shape, spec, mesh), spec,
                mesh)
            if not spec.own:
                flat[path] = _host_array(whole)
                continue
            (axis,) = spec.own
            for i, leaf in enumerate(whole):
                flat[_own_name(path, axis, i)] = _host_array(leaf)
        if mesh.rank == 0 and not done:
            self._write(step, flat, extra)
        elif mesh.rank == 0:
            self._gc()
        dist.barrier()
        if not self._committed(step):
            raise RuntimeError(f"rank {mesh.rank}: step {step} has no COMMIT "
                               f"after rank 0's save")

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: Optional[Dict]):
        with self._lock:
            final = os.path.join(self.dir, f"step_{step:09d}")
            tmp = final + f".tmp{self.host_id}"
            os.makedirs(tmp, exist_ok=True)
            shard_file = os.path.join(tmp, f"shard_{self.host_id}.npz")
            np.savez(shard_file, **flat)
            manifest = {
                "step": step,
                "time": time.time(),
                "extra": extra or {},
                "arrays": [
                    {"name": k, "shape": list(v.shape),
                     "dtype": _dtype_name(v), "shard": self.host_id,
                     "offset": 0, "length": int(v.size)}
                    for k, v in flat.items()
                ],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                # Never committed (a torn write): replaced, not committed
                # as it is.
                shutil.rmtree(final)
            os.replace(tmp, final)
            # Completion writeback: the COMMIT flag is written last.
            with open(os.path.join(final, "COMMIT"), "w") as f:
                f.write("1")
            self._gc()

    def _committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self.dir, f"step_{step:09d}",
                                           "COMMIT"))

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- discovery / restore -------------------------------------------------
    def committed_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or ".tmp" in name:
                continue
            if os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, device=None, mesh=None,
                specs: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` (its leaves give each
        array's dtype; a leaf that is not a tensor gives a tensor of the
        stored dtype), as tensors on ``device`` (default: each leaf's own
        device). On a process ``mesh``, each leaf is this rank's block of
        it under ``specs``, on the mesh's device unless ``device`` is
        given. Returns ``(tree, extra)``."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        if not os.path.exists(os.path.join(d, "COMMIT")):
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = {}
        for name in os.listdir(d):
            if name.startswith("shard_") and name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    data.update({k: z[k] for k in z.files})

        missing = set(flatten(like)) - set(data)
        if missing:
            raise KeyError(f"checkpoint missing arrays: {sorted(missing)[:5]}")

        spec_of = flatten(specs) if mesh is not None else {}
        if mesh is not None and device is None:
            device = mesh.device

        def rebuild(path, leaf):
            spec = spec_of.get(path)
            name = path
            if spec is not None and spec.own:
                (axis,) = spec.own
                own = _own_name(path, axis, mesh.coords.get(axis, 0))
                name = own if own in data else path
            arr = data[name]
            if arr.dtype.kind == "V":
                # bf16 round-trips through npz as raw 2-byte void.
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, copy=True))
            if spec is not None:
                from repro_torch.distributed.sharding import take_block
                t = take_block(t, spec, mesh).clone()
            if isinstance(leaf, torch.Tensor):
                dev = leaf.device if device is None else device
                return t.to(device=dev, dtype=leaf.dtype)
            return t if device is None else t.to(device)

        return map_with_path(rebuild, like), manifest.get("extra", {})
