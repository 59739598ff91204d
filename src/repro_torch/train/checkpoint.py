"""Checkpointing (twin of ``repro.train.checkpoint``): one ``.npy`` file a
leaf plus a JSON manifest, an asynchronous save, and restore onto a target
device (the elastic re-mesh path).

Layout, the reference's:

  <dir>/step_00000042/
    manifest.json        step, paths, shapes, dtypes, crc32, metadata, time
    0000.npy ... NNNN.npy  one file a leaf, in the tree's leaf order

A save writes ``.tmp_step_*`` and renames it (an atomic publish); a
leftover ``.tmp_step_*`` is a writer that died and is never restored. Each
leaf is checked on restore against the manifest's shape, dtype and the
CRC32 of its bytes. ``paths`` are written as ``jax.tree_util.keystr``
writes them (``tree.keystr``), from the port's own leaf order;
the port's layers are lists, so its paths name a layer's index where the
reference's stacked tree has none. numpy has no bfloat16: a bf16 leaf is
saved as its raw 16 bits (a uint16 ``.npy``) under the manifest dtype
``bfloat16``, and its CRC32 is that of the same bytes.

Every rank holds the whole state under data parallelism, so one rank (the
elastic runner's rank 0) writes.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
import warnings
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import (keystr, tree_leaves, tree_leaves_with_path,
                    tree_unflatten_like)

_BF16 = "bfloat16"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint shard failed integrity verification (shape / dtype /
    CRC32 against the manifest). The message names the bad leaf."""


def _crc(arr: np.ndarray) -> int:
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(raw) & 0xFFFFFFFF


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """(the array written, the manifest's dtype string) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten_host(tree: Any) -> tuple[list, list, list]:
    """(paths, host arrays, manifest dtypes) of ``tree``'s leaves."""
    pairs = tree_leaves_with_path(tree)
    host = [_to_host(leaf) for _, leaf in pairs]
    return ([keystr(p) for p, _ in pairs], [h for h, _ in host],
            [d for _, d in host])


def _write(ckpt_dir: Path, step: int, paths: list, host: list,
           dtypes: list, metadata: Optional[dict]) -> Path:
    path = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(h.shape) for h in host],
        "dtypes": dtypes,
        # per-leaf CRC32 of the raw array bytes: restore verifies each
        # shard against this before handing the state back
        "crc32": [_crc(h) for h in host],
        "metadata": metadata or {},
        "time": time.time(),
    }
    for i, h in enumerate(host):
        np.save(tmp / f"{i:04d}.npy", h)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)                    # atomic publish
    return path


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> Path:
    """Blocking save of ``tree`` (tensors or numpy arrays) as ``step``.
    Returns the checkpoint's path."""
    return _write(Path(ckpt_dir), step, *_flatten_host(tree), metadata)


def latest_checkpoint(ckpt_dir: str | Path) -> Optional[Path]:
    """The newest published ``step_*`` directory, or None. Warns about
    leftover partial directories, which are never selected."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    stale = sorted(p.name for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith(".tmp_step_"))
    if stale:
        # a .tmp dir is a writer that died mid-save: its contents are
        # partial; the atomic rename already keeps them unselectable
        warnings.warn(
            f"{ckpt_dir}: skipping {len(stale)} leftover partial "
            f"checkpoint dir(s) from a crashed save: {stale}",
            RuntimeWarning, stacklevel=2)
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    return steps[-1] if steps else None


def restore_checkpoint(path: str | Path, like: Any,
                       devices: Optional[Any] = None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (tensors, on any device,
    ``meta`` included): each leaf cast to its ``like`` leaf's dtype and put
    on ``devices`` (a device, or a tree of them like ``like``; None: the
    ``like`` leaf's own device). Returns (tree, the manifest's step).

    Every shard is verified against the manifest (shape, dtype and, for
    checkpoints that carry it, the CRC32 of its bytes); a mismatch raises
    ``CheckpointCorrupt`` naming the bad leaf."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = tree_leaves(like)
    if len(leaves) != len(manifest["paths"]):
        raise AssertionError(f"tree mismatch: {len(leaves)} leaves vs "
                             f"{len(manifest['paths'])}")
    crcs = manifest.get("crc32") or [None] * len(leaves)
    if devices is None or isinstance(devices, (str, torch.device)):
        targets = [devices] * len(leaves)
    else:
        targets = tree_leaves(devices)
    out = []
    for i, (leaf, dev) in enumerate(zip(leaves, targets)):
        name = manifest["paths"][i]
        want = manifest["dtypes"][i]
        arr = np.load(path / f"{i:04d}.npy")
        if list(arr.shape) != list(manifest["shapes"][i]):
            raise CheckpointCorrupt(
                f"{path}/{i:04d}.npy (leaf {name!r}): shard shape "
                f"{list(arr.shape)} != manifest {manifest['shapes'][i]}")
        if str(arr.dtype) != ("uint16" if want == _BF16 else want):
            raise CheckpointCorrupt(
                f"{path}/{i:04d}.npy (leaf {name!r}): shard dtype "
                f"{arr.dtype} != manifest {want}")
        if crcs[i] is not None and _crc(arr) != crcs[i]:
            raise CheckpointCorrupt(
                f"{path}/{i:04d}.npy (leaf {name!r}): CRC32 mismatch — "
                f"shard bytes corrupted on disk")
        if hasattr(leaf, "shape") and list(arr.shape) != list(leaf.shape):
            raise CheckpointCorrupt(
                f"{path}/{i:04d}.npy (leaf {name!r}): checkpoint shape "
                f"{list(arr.shape)} != restore-target shape "
                f"{list(leaf.shape)}")
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if want == _BF16 else torch.from_numpy(arr))
        if isinstance(leaf, torch.Tensor):
            t = t.to(leaf.dtype)
            dev = leaf.device if dev is None else dev
        out.append(t if dev is None else t.to(dev))
    return tree_unflatten_like(like, out), manifest["step"]


def prune_checkpoints(ckpt_dir: str | Path, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p)


class AsyncCheckpointer:
    """Non-blocking save: the device-to-host copy on the caller's thread
    (so the caller may go on updating the tensors), disk IO on a worker.
    An error of the worker (a full disk, a directory that cannot be made)
    is raised again by the next ``wait`` or ``save``: a failed save fails
    the run."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[Path] = None

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        self.wait()
        flat = _flatten_host(tree)

        def work():
            try:
                self.last_path = _write(self.ckpt_dir, step, *flat, metadata)
                prune_checkpoints(self.ckpt_dir, self.keep)
            except BaseException as e:      # handed to the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
