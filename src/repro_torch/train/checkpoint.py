"""Checkpoints: atomic, manifest-described, numpy only.

Twin of ``src/repro/train/checkpoint.py:48-180``, with the same layout on
disk, so each package reads what the other wrote:

    <dir>/step_00000100/
        manifest.json     step, time, leaf index {path -> file, shape,
                          dtype}, user metadata
        arrays_00000.npz  the leaves as numpy arrays

A tree is a nest of dicts, lists, tuples and NamedTuples whose leaves
are numpy arrays or torch tensors. It is flattened in JAX's leaf order (a
NamedTuple by field, a dict by sorted key, a list or tuple by position;
None holds no leaf), each leaf keyed by its path as the reference keys it
(``.params/layers/wq`` for a NamedTuple field ``params``), and named
``a00000``, ``a00001``, ... in that order. A write lands in
``<dir>/.tmp_step_N`` and is renamed to ``step_N`` only after its manifest
is fsynced, so a crash mid-write never leaves a directory ``latest_step``
would pick.

A bfloat16 leaf is stored as the reference stores an ml_dtypes leaf: its
bytes as uint8 with a trailing axis of 2, the manifest naming the dtype
``bfloat16``. The port reads and writes those bytes through
``tensor.view(torch.uint8)``, with no ml_dtypes, and ``restore`` returns
such a leaf as a CPU bfloat16 tensor (numpy has no bfloat16 of its own);
every other leaf comes back as a numpy array. ``save`` takes a bfloat16
leaf as a torch tensor; other ml_dtypes (fp8) are refused both ways.

Under a mesh the layout on disk stays the reference's: whole leaves
(``models/convert.py::train_state_to_numpy`` gathers a sharded state in
mesh order onto the mesh's first rank), written by that rank (``save(...,
policy=)``; the others wait for the write). ``restore(..., cut=)`` is the
elastic restore, the twin of the reference's ``shardings=``: every rank
reads the whole leaves one at a time and keeps its shard of each
(``convert.shard_cut``: cut by the leaf's rule on whatever mesh it runs),
so a state saved on one mesh restores on another, or on one device.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Callable, Mapping

import numpy as np
import torch


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _children(tree):
    """(path entry, subtree) pairs in JAX's flattening order; None for a
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, Mapping):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), sub) for i, sub in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path, leaf)] in JAX's leaf order, paths as the reference's
    checkpoint keys them."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for entry, sub in kids:
        out += flatten_with_paths(sub, f"{prefix}/{entry}" if prefix
                                  else entry)
    return out


def _unflatten(like, leaves):
    """A tree shaped as ``like`` holding the next leaves of the iterator
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, Mapping):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _stored(key: str, leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk and its logical dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.reshape(-1).view(torch.uint8).reshape(
                *t.shape, 2).numpy(), "bfloat16")
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":
        raise ValueError(f"leaf {key!r} has numpy dtype {arr.dtype}; pass "
                         f"a bfloat16 leaf as a torch tensor")
    return arr, str(arr.dtype)


def _writer(policy) -> bool:
    """Whether this rank writes: always without a mesh, else the mesh's
    first rank."""
    if policy is None or policy.mesh is None:
        return True
    from repro_torch.dist.policy import shard_rank
    return shard_rank(policy) == 0


def _barrier(policy) -> None:
    if policy is not None and policy.mesh is not None:
        import torch.distributed as dist
        dist.barrier(group=policy.group)


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
         policy=None) -> str:
    """Atomically save a tree (module docstring). Returns the final
    directory path. Under a mesh ``policy`` every rank calls it: the
    mesh's first rank with the whole tree, which it writes, the others
    with anything (``convert.train_state_to_numpy`` gives them None);
    every rank returns once the step is complete."""
    if not _writer(policy):
        _barrier(policy)
        return _step_dir(ckpt_dir, step)
    try:
        return _save(ckpt_dir, step, tree, metadata)
    finally:
        _barrier(policy)


def _save(ckpt_dir: str, step: int, tree, metadata: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    index, arrays = {}, {}
    for i, (key, leaf) in enumerate(flatten_with_paths(tree)):
        arr, dtype = _stored(key, leaf)
        name = f"a{i:05d}"
        arrays[name] = arr
        index[key] = {"file": name, "shape": list(arr.shape),
                      "dtype": dtype}
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


def restore(ckpt_dir: str, step: int, like,
            cut: Callable | None = None) -> tuple[object, dict]:
    """Restore a tree shaped as ``like`` (its leaves' values ignored,
    their shapes checked): numpy arrays, bfloat16 leaves as CPU tensors.
    Returns (tree, metadata).

    ``cut(path, whole leaf)`` (the elastic restore, ``convert.shard_cut``)
    gives the part of each leaf to keep as it is read: under a mesh
    ``like`` is the rank's tree, shaped as its shards
    (``convert.train_state_to_numpy(state)`` of the rank's state)."""
    manifest = read_manifest(ckpt_dir, step)
    data = np.load(os.path.join(_step_dir(ckpt_dir, step),
                                "arrays_00000.npz"))
    leaves = []
    for key, leaf_like in flatten_with_paths(like):
        entry = manifest["index"].get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[entry["file"]]
        want = tuple(leaf_like.shape)
        bits = entry["dtype"] == "bfloat16"
        whole = tuple(arr.shape[:-1] if bits else arr.shape)
        if str(arr.dtype) != ("uint8" if bits else entry["dtype"]):
            raise ValueError(f"leaf {key!r} is stored as {arr.dtype} for "
                             f"dtype {entry['dtype']}; of the ml_dtypes "
                             f"the port reads bfloat16 only")
        if bits:
            arr = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)
                                   ).view(torch.bfloat16).reshape(whole)
        if cut is not None:
            arr = cut(key, arr)
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {key!r}: checkpoint shape {whole}"
                             + (f" cut to {tuple(arr.shape)}" if cut else "")
                             + f" != {want}")
        leaves.append(arr)
    return _unflatten(like, iter(leaves)), manifest["metadata"]


def prune(ckpt_dir: str, keep: int = 3,
          protect: tuple | list | set = (), policy=None) -> None:
    """Delete all but the newest ``keep`` complete checkpoints; steps in
    ``protect`` are never deleted, on top of the keep budget. Under a
    mesh ``policy`` the writing rank deletes (``save``)."""
    if not _writer(policy):
        return
    steps = _complete_steps(ckpt_dir)
    doomed = steps if keep <= 0 else steps[:-keep]
    for s in doomed:
        if s not in set(protect):
            shutil.rmtree(_step_dir(ckpt_dir, s))
