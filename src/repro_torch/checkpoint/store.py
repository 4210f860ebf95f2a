"""Atomic, resumable checkpoints of trees of tensors — the port of
``repro.checkpoint.store``, on the same on-disk layout:

Layout:   <dir>/step_<n:08d>/
              manifest.json          tree paths -> shapes/dtypes
              arrays.npz             leaf data (path-keyed)
              _COMMITTED             atomicity marker (written LAST)

  * atomic: every file is written into a temporary directory that is
    renamed into place once ``_COMMITTED`` is in it; restore ignores
    uncommitted steps,
  * resumable: ``latest_step`` finds the newest committed step,
  * portable: a tree is nested ``dict`` / ``list`` / ``tuple`` of tensors,
    numpy arrays and scalars, keyed by ``/``-joined paths (a dict key as
    ``str(key)``, a sequence index as ``[i]``, dict keys sorted), as the
    JAX package keys its pytrees, so a step written by either package
    loads in the other (``bridge.load_step_dir`` reads it with numpy
    alone).  numpy has no bfloat16: a bf16 leaf is written as its 2-byte
    void view with ``"bfloat16"`` in the manifest — the form JAX's
    ``np.savez`` of an ``ml_dtypes`` array takes — and read back by
    reinterpreting its bits,
  * async-friendly: ``CheckpointManager(save_async=True)`` copies the
    tree to host arrays on the caller's thread (the copy waits for the
    device) and hands them to a writer thread.

There is no mesh: a leaf is restored onto the device of the matching leaf
of ``like``, in its dtype.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

_SEP = "/"


def _leaves(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in the JAX package's flatten order: dict keys
    sorted, sequences in order, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (f"[{i}]",))
    elif tree is not None:
        yield _SEP.join(prefix), tree


def _host(leaf) -> tuple[np.ndarray, str]:
    """One leaf as a host numpy array of its own (never a view of a live
    tensor) and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:     # numpy has none: 2-byte records
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.array(leaf)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array
        return a.view("V2"), "bfloat16"
    return a, str(a.dtype)


def _flatten_with_paths(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _write(flat: dict, directory: pathlib.Path, step: int) -> pathlib.Path:
    final = directory / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=str(directory)))
    try:
        manifest = {k: {"shape": list(a.shape), "dtype": name}
                    for k, (a, name) in flat.items()}
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        (tmp / "_COMMITTED").write_text(str(step))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save_pytree(tree: Any, directory: str | os.PathLike, step: int) -> pathlib.Path:
    """Atomic save of one tree as step_<step>."""
    return _write(_flatten_with_paths(tree), pathlib.Path(directory), step)


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and (d / "_COMMITTED").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _like_leaf(arr: np.ndarray, like, key: str):
    """``arr`` in ``like``'s dtype, on ``like``'s device (a tensor) or as a
    numpy array (any other leaf).  A void record of the dtype's width has
    its bits reinterpreted; no value is ever cast."""
    if isinstance(like, torch.Tensor):
        if arr.dtype.kind == "V":
            if arr.dtype.itemsize != like.element_size():
                raise ValueError(f"{key}: {arr.dtype.itemsize}-byte records "
                                 f"for a {like.dtype} leaf")
            bits = np.ascontiguousarray(arr).view(f"i{arr.dtype.itemsize}")
            t = torch.from_numpy(bits).view(like.dtype)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if t.dtype != like.dtype:
                raise ValueError(f"{key}: stored {arr.dtype} for a "
                                 f"{like.dtype} leaf")
        return t.to(like.device)
    want = np.asarray(like).dtype
    if arr.dtype != want:
        if arr.dtype.kind != "V" or arr.dtype.itemsize != want.itemsize:
            raise ValueError(f"{key}: stored {arr.dtype} for a {want} leaf")
        arr = arr.view(want)
    return arr


def _rebuild(like: Any, data, prefix: tuple = ()):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], data, prefix + (str(k),)) for k in like}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(sub, data, prefix + (f"[{i}]",))
               for i, sub in enumerate(like)]
        return out if isinstance(like, list) else type(like)(out)
    if like is None:
        return None
    key = _SEP.join(prefix)
    return _like_leaf(data[key], like, key)


def restore_pytree(like: Any, directory: str | os.PathLike,
                   step: int | None = None) -> Any:
    """Restore a committed step (the latest when ``step`` is None) into the
    structure of ``like``: each leaf on the device and in the dtype of
    ``like``'s leaf, its bits as they were saved."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    src = directory / f"step_{step:08d}"
    if not (src / "_COMMITTED").exists():
        raise FileNotFoundError(f"step {step} is not committed")
    with np.load(src / "arrays.npz") as data:
        return _rebuild(like, data)


class CheckpointManager:
    """Keeps the last ``keep`` committed steps; optional async writer."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 save_async: bool = False):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.save_async = save_async
        self._pending: threading.Thread | None = None

    def save(self, tree: Any, step: int):
        flat = _flatten_with_paths(tree)      # the host copy, on-path
        if self.save_async:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(flat, step), daemon=True)
            self._pending.start()
        else:
            self._write(flat, step)

    def _write(self, flat, step):
        _write(flat, self.directory, step)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore(self, like: Any, step: int | None = None):
        self.wait()
        return restore_pytree(like, self.directory, step)

    def latest_step(self) -> int | None:
        self.wait()
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.directory.iterdir()
            if d.name.startswith("step_") and (d / "_COMMITTED").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)
