"""Checkpoint manager: atomic, checksummed, async.

Counterpart of ``repro.training.checkpoint``, with its layout per step:
    <root>/step_<N>.tmp/            (written)
        manifest.json               paths, shapes, dtypes, crc32 per leaf,
                                    step
        arrays.npz                  all leaves (compressed npz)
        treedef.pkl, extra.pkl      the state's structure; the caller's
                                    extra (data-pipeline cursor, step)
    <root>/step_<N>/                (atomic rename on completion)
    <root>/LATEST                   text file -> step number (atomic)

A state is a tree of tensors (``training.tree``). numpy has no bfloat16, so
a bf16 leaf is stored as its 16 bits (int16) and the manifest records its
torch dtype; restore views the bits as bf16 again, bit-exact. Restore puts
every leaf on the device the caller names, or, given a tree of shardings
(``launch.sharding.NamedSharding`` on a DeviceMesh, as ``launch.specs``
builds them), distributes each leaf onto its mesh: a checkpoint written
on one mesh restores onto another (elastic restore). A DTensor leaf is
saved whole (``full_tensor``, a collective every rank joins), and only
rank 0 of an initialised process group writes.

Fault-tolerance contract: writes never clobber the previous checkpoint; a
crash mid-write leaves a ``.tmp`` dir that is ignored (and GC'd) on
restart; CRC mismatches raise before any leaf reaches the model.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.training import tree as tree_lib

# torch dtypes stored under another numpy dtype of the same width
_AS_BITS = {torch.bfloat16: torch.int16}


def _key(path) -> str:
    return "/".join(path)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` (taken now, so later in-place steps do not
    reach it) and its torch dtype's name."""
    name = str(t.dtype).removeprefix("torch.")
    if isinstance(t, DTensor):
        t = t.full_tensor()
    host = t.detach().to("cpu", copy=True)
    if t.dtype in _AS_BITS:
        host = host.view(_AS_BITS[t.dtype])
    return host.numpy(), name


def _flatten(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    return {_key(path): _to_numpy(leaf)
            for path, leaf in tree_lib.flatten_with_paths(tree)}


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)
        self._gc_tmp()

    # -- write -----------------------------------------------------------------
    def save(self, step: int, state: Any,
             extra: Optional[Dict] = None) -> None:
        flat = _flatten(state)           # host copy happens sync (consistent)
        skeleton = tree_lib.unflatten(state, [None] * len(flat))
        if dist.is_initialized() and dist.get_rank() != 0:
            return                       # rank 0 writes
        if self._thread is not None:
            self._thread.join()          # one in-flight write at a time
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, skeleton, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, skeleton, extra or {})

    def wait(self) -> None:  # simcheck: ignore[units]
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
               skeleton, extra: Dict) -> None:
        tmp = os.path.join(self.root, f"step_{step}.tmp")
        final = os.path.join(self.root, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype),
                           "torch_dtype": name,
                           "crc32": zlib.crc32(np.ascontiguousarray(a)
                                               .tobytes())}
                       for k, (a, name) in flat.items()},
        }
        np.savez_compressed(os.path.join(tmp, "arrays.npz"),
                            **{k: a for k, (a, _) in flat.items()})
        with open(os.path.join(tmp, "treedef.pkl"), "wb") as f:
            pickle.dump(skeleton, f)
        with open(os.path.join(tmp, "extra.pkl"), "wb") as f:
            pickle.dump(extra, f)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                              # atomic commit
        with open(os.path.join(self.root, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.root, "LATEST.tmp"),
                   os.path.join(self.root, "LATEST"))
        self._gc_old()

    # -- read ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: Optional[int] = None, device="cuda",
                shardings: Any = None) -> Tuple[Any, Dict]:
        """Returns (state, extra), every leaf on ``device`` (CUDA unless
        asked), or, with ``shardings`` (a tree of the state's structure,
        each leaf a ``NamedSharding`` on a DeviceMesh), each leaf a DTensor
        of its sharding on its mesh's device: every rank keeps its own
        shard of the leaf it read. Raises ``IOError`` on a CRC mismatch
        before building any tensor."""
        dev = None if shardings is not None else resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(d, "treedef.pkl"), "rb") as f:
            skeleton = pickle.load(f)
        with open(os.path.join(d, "extra.pkl"), "rb") as f:
            extra = pickle.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        for k, info in manifest["leaves"].items():
            crc = zlib.crc32(np.ascontiguousarray(flat[k]).tobytes())
            if crc != info["crc32"]:
                raise IOError(f"checkpoint leaf {k} corrupt (crc mismatch)")

        def tensor(path):
            info = manifest["leaves"][_key(path)]
            t = torch.from_numpy(flat[_key(path)])
            dtype = getattr(torch, info["torch_dtype"])
            t = t.view(dtype) if dtype in _AS_BITS else t
            return t if dev is None else t.to(dev)

        paths = [p for p, _ in tree_lib.flatten_with_paths(skeleton)]
        if shardings is None:
            return tree_lib.unflatten(skeleton,
                                      [tensor(p) for p in paths]), extra

        def place(path, s):
            t = tensor(path).to(s.mesh.device_type)
            return distribute_tensor(t, s.mesh, s.placements,
                                     src_data_rank=None)

        return tree_lib.unflatten(skeleton, [
            place(p, s) for p, s in zip(paths, tree_lib.leaves(shardings),
                                        strict=True)]), extra

    # -- gc ----------------------------------------------------------------------
    def _gc_old(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    def _gc_tmp(self) -> None:
        for d in os.listdir(self.root):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
