"""Step-atomic checkpointing (the port of `repro.checkpoint.checkpointing`).

Layout (one directory per step), the same on disk as the reference's, so
either package restores the other's snapshots:

    ckpt_dir/
      step_000120/
        manifest.json        # leaf paths, dtypes, shapes, sha256, extra
        arrays/<idx>.npy     # one file per leaf, raw bytes as uint8
      step_000120.COMMITTED  # atomic commit marker (written last)

  * step-atomic: the COMMITTED marker is written only after every array
    file and the manifest are in place — a preempted writer never leaves a
    half-checkpoint that `restore` would accept;
  * integrity: sha256 per array, verified on restore;
  * async: `save(blocking=False)` writes on a single background thread
    (overlapping the next step); every leaf is copied to host numpy
    *before* the writer sees it, so a caller may reuse its buffers (or its
    device tensors) at once;
  * GC: `keep_last` bounds disk usage.

A state tree is nested dicts, lists, tuples and namedtuples with numpy
arrays, torch tensors or Python scalars at the leaves; None is an empty
subtree (no leaf). Leaves are numbered in the reference's flattening order
— dict keys sorted, sequences and a namedtuple's fields in order — and a
leaf's path joins its keys with "/": a dict key, a sequence index, or
".field" for a namedtuple field (as JAX names a namedtuple's leaves, so an
optimizer state `{"opt": OptState(step, mu, nu)}` is stored under
`opt/.step`, `opt/.mu/...`, `opt/.nu/...` by either package).
"""
from __future__ import annotations

import concurrent.futures as futures
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

# numpy has no bfloat16: such leaves are stored as their uint16 bits under
# the dtype name "bfloat16" (the name the reference writes) and come back
# as torch.bfloat16 tensors.
_BF16 = "bfloat16"


def _flatten(tree, prefix=()):
    """[(path tuple, leaf)] in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += _flatten(v, prefix + ("." + name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _unflatten(tree, values):
    """`tree` with its leaves replaced, in flattening order, by `values`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], values) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)._make(_unflatten(v, values) for v in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values) for v in tree)
    return next(values)


def _tree_paths(tree):
    flat = _flatten(tree)
    return (["/".join(str(k) for k in path) for path, _ in flat],
            [leaf for _, leaf in flat])


def _to_host(x):
    """A host numpy copy of one leaf (raw uint16 bits for bfloat16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return np.array(t.view(torch.int16).numpy().view(np.uint16)), \
                _BF16
        return np.array(t.numpy()), None
    arr = np.array(x)
    return arr, None


class CheckpointManager:
    # In-flight async saves allowed before save() blocks: one running plus
    # one queued (the reference's bound: two snapshots of host memory).
    MAX_IN_FLIGHT = 2

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._pool = futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []  # FIFO of submitted write futures
        self._lock = threading.Lock()

    # ---- save ----
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None, blocking: bool = True):
        """state: a tree of arrays/tensors. extra: JSON-able metadata."""
        paths, leaves = _tree_paths(state)
        host = [_to_host(x) for x in leaves]  # before the writer runs

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step:06d}")
            final = os.path.join(self.dir, f"step_{step:06d}")
            marker = final + ".COMMITTED"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
            manifest = {"step": step, "leaves": [], "extra": extra or {}}
            for i, (p, (arr, dtype_name)) in enumerate(zip(paths, host)):
                f = os.path.join(tmp, "arrays", f"{i}.npy")
                np.save(f, np.ascontiguousarray(arr).view(np.uint8)
                        .reshape(-1))
                with open(f, "rb") as fh:
                    digest = hashlib.sha256(fh.read()).hexdigest()
                manifest["leaves"].append(
                    {"path": p, "file": f"arrays/{i}.npy",
                     "shape": list(arr.shape),
                     "dtype": dtype_name or str(arr.dtype),
                     "sha256": digest})
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh)
                fh.flush()
                os.fsync(fh.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            with open(marker, "w") as fh:   # commit point
                fh.write(str(step))
                fh.flush()
                os.fsync(fh.fileno())
            self._gc()
            return final

        with self._lock:
            while len(self._pending) >= self.MAX_IN_FLIGHT:
                self._pending.pop(0).result()
            self._pending.append(self._pool.submit(_write))
        if blocking:
            return self.wait()
        return None

    def wait(self):
        result = None
        with self._lock:
            while self._pending:
                result = self._pending.pop(0).result()
        return result

    # ---- restore ----
    def committed_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.endswith(".COMMITTED"):
                steps.append(int(name[len("step_"):-len(".COMMITTED")]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: Optional[int] = None,
                verify: bool = True, host: bool = False):
        """Restore into the structure of `target_tree` (values replaced).

        host=True returns host numpy arrays with their saved dtypes —
        float64 stays float64, which the resilient runtime's byte-identical
        resume needs. host=False returns torch tensors, each on the device
        of the target leaf it replaces (CPU where that leaf is not a
        tensor). A bfloat16 leaf always comes back as a torch.bfloat16
        tensor (numpy has no such dtype)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint found")
        final = os.path.join(self.dir, f"step_{step:06d}")
        with open(os.path.join(final, "manifest.json")) as fh:
            manifest = json.load(fh)
        paths, leaves = _tree_paths(target_tree)
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        out = []
        for p, ref in zip(paths, leaves):
            meta = by_path[p]
            f = os.path.join(final, meta["file"])
            if verify:
                with open(f, "rb") as fh:
                    digest = hashlib.sha256(fh.read()).hexdigest()
                if digest != meta["sha256"]:
                    raise IOError(f"checkpoint corruption in {p}: "
                                  f"sha mismatch")
            raw = np.load(f)
            if meta["dtype"] == _BF16:
                bits = raw.view(np.int16).reshape(meta["shape"])
                val = torch.from_numpy(bits.copy()).view(torch.bfloat16)
            else:
                arr = raw.view(np.dtype(meta["dtype"])).reshape(
                    meta["shape"])
                val = arr if host else torch.from_numpy(arr.copy())
            if isinstance(val, torch.Tensor) and not host \
                    and isinstance(ref, torch.Tensor):
                val = val.to(ref.device)
            out.append(val)
        return _unflatten(target_tree, iter(out)), manifest["extra"], step

    # ---- GC ----
    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:06d}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir,
                                       f"step_{s:06d}.COMMITTED"))
            except OSError:
                pass
