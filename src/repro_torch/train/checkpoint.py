"""Checkpoints: atomic, manifest-described, numpy only.

Twin of ``src/repro/train/checkpoint.py:48-180``, with the same layout on
disk, so each package reads what the other wrote:

    <dir>/step_00000100/
        manifest.json     step, time, leaf index {path -> file, shape,
                          dtype}, user metadata
        arrays_00000.npz  the leaves as numpy arrays

A tree here is a flat ``dict[str, np.ndarray]``; its leaves are named
``a00000``, ``a00001``, ... in sorted-key order, as the reference's
``jax.tree_util`` flattens a dict. A write lands in ``<dir>/.tmp_step_N``
and is renamed to ``step_N`` only after its manifest is fsynced, so a
crash mid-write never leaves a directory ``latest_step`` would pick.

Left out: the reference stores ml_dtypes leaves (bfloat16, fp8) as their
bytes; nothing the port saves has such a leaf, so ``save`` refuses one and
``restore`` refuses a checkpoint that holds one.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Mapping

import numpy as np


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree: Mapping[str, np.ndarray],
         metadata: dict | None = None) -> str:
    """Atomically save a flat tree of numpy arrays. Returns the final
    directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    index, arrays = {}, {}
    for i, key in enumerate(sorted(tree)):
        arr = np.asarray(tree[key])
        if arr.dtype.kind == "V":
            raise ValueError(f"leaf {key!r} has dtype {arr.dtype}; the "
                             f"port saves no ml_dtypes leaf")
        name = f"a{i:05d}"
        arrays[name] = arr
        index[key] = {"file": name, "shape": list(arr.shape),
                      "dtype": str(arr.dtype)}
    np.savez(os.path.join(tmp, "arrays_00000.npz"), **arrays)

    manifest = {"step": step, "time": time.time(), "index": index,
                "metadata": metadata or {}, "format": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _complete_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    """Largest step with a complete (manifest-bearing) checkpoint."""
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The manifest of one saved step: leaf index, user metadata, time."""
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, like: Mapping[str, np.ndarray]
            ) -> tuple[dict, dict]:
    """Restore the leaves named by ``like`` (values ignored; shapes
    checked) as numpy arrays. Returns (tree, metadata)."""
    manifest = read_manifest(ckpt_dir, step)
    data = np.load(os.path.join(_step_dir(ckpt_dir, step),
                                "arrays_00000.npz"))
    tree = {}
    for key in sorted(like):
        entry = manifest["index"].get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[entry["file"]]
        if str(arr.dtype) != entry["dtype"]:
            raise ValueError(f"leaf {key!r} is stored as {arr.dtype} for "
                             f"dtype {entry['dtype']}; the port reads no "
                             f"ml_dtypes leaf")
        want = tuple(np.shape(like[key]))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} "
                             f"!= {want}")
        tree[key] = arr
    return tree, manifest["metadata"]


def prune(ckpt_dir: str, keep: int = 3,
          protect: tuple | list | set = ()) -> None:
    """Delete all but the newest ``keep`` complete checkpoints; steps in
    ``protect`` are never deleted, on top of the keep budget."""
    steps = _complete_steps(ckpt_dir)
    doomed = steps if keep <= 0 else steps[:-keep]
    for s in doomed:
        if s not in set(protect):
            shutil.rmtree(_step_dir(ckpt_dir, s))
