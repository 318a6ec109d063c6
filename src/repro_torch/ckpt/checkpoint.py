"""Checkpoints of training state (pytrees: the step checkpoints) and
epoch-tagged per-home ``BlockArray`` tile checkpoints (the serving
session's shared state).

The layouts, the leaf paths and the ``.npz`` keys are the JAX package's
(``src/repro/ckpt/checkpoint.py``), so a checkpoint written by either
package restores in the other::

    <dir>/step_<k>/manifest.json     # leaf paths, shapes, dtypes, meta
    <dir>/step_<k>/arr_<i>.npy       # one file per leaf
    <dir>/step_<k>/_COMMITTED        # written last -> crash-safe commit

    <dir>/epoch_<e>/manifest.json    # array geometry, homes, meta
    <dir>/epoch_<e>/home_<h>.npz     # "<name>|i,j" -> tile (npy inside)
    <dir>/epoch_<e>/_COMMITTED       # written last -> crash-safe commit

A tree is nested tuples, lists, named tuples (``AdamWState``), dicts
and ``nn.Module``s (a ``Decoder``, as its parameter tree) over tensors;
each leaf is named by the reference's ``jax.tree_util`` path string
(``[0]/['blocks']/['attn']/['wq']/['w']``, ``[1]/.nu/['embed']/['table']``,
``[1]/.step``), dict keys sorted as JAX sorts them.  Leaves and tiles
are snapshotted to host memory synchronously (one device-to-host copy
each), then written by daemon threads when ``async_save``.  ``np.save``
and ``np.savez`` store raw npy records: the round trip is bit-identical.
Placing restored leaves by sharding rules (the reference's
``shardings=``) waits for the training mesh hooks (ROADMAP queue 1 item
12).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch import nn

from ..core.blocks import dtype_name
from ..models.transformer import tree as param_tree

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "save_tiles", "latest_epoch", "restore_tiles"]


def _leaves_with_paths(node, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order and notation."""
    def sub(key: str) -> str:
        return f"{prefix}/{key}" if prefix else key

    if node is None:
        return []
    if isinstance(node, nn.Module):
        node = param_tree(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [pair for name in node._fields
                for pair in _leaves_with_paths(getattr(node, name),
                                               sub(f".{name}"))]
    if isinstance(node, (tuple, list)):
        return [pair for i, child in enumerate(node)
                for pair in _leaves_with_paths(child, sub(f"[{i}]"))]
    if isinstance(node, dict):
        return [pair for key in sorted(node)
                for pair in _leaves_with_paths(node[key], sub(f"[{key!r}]"))]
    return [(prefix, node)]


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy, so the writer never reads a tensor training updates
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save_checkpoint(directory: str, step: int, tree, *, meta: dict | None
                    = None, async_save: bool = False):
    """Serialize a tree of tensors.  Returns the checkpoint path (or the
    writer thread when ``async_save``: the leaves are on the host before
    it starts, so training may update them at once)."""
    pairs = _leaves_with_paths(tree)
    paths = [p for p, _ in pairs]
    host_leaves = [_to_host(leaf) for _, leaf in pairs]

    def write():
        out = os.path.join(directory, f"step_{step:08d}")
        tmp = out + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "meta": meta or {}, "leaves": []}
        for i, (p, arr) in enumerate(zip(paths, host_leaves)):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            manifest["leaves"].append(
                {"path": p, "shape": list(arr.shape),
                 "dtype": str(arr.dtype), "file": f"arr_{i}.npy"})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(out, ignore_errors=True)
        os.replace(tmp, out)
        return out

    if async_save:
        t = threading.Thread(target=write, daemon=True,
                             name=f"ckpt-writer-{step}")
        t.start()
        return t
    return write()


def latest_step(directory: str) -> int | None:
    """Newest *committed* step checkpoint under ``directory`` (None when
    there is none — a crash mid-write leaves no marker)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "_COMMITTED")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, like_tree):
    """Restore into ``like_tree``: every tensor leaf (a ``Decoder``'s
    parameters among them) is filled in place, cast to its dtype on its
    device.  Raises on a missing, extra or misshapen leaf.  Returns
    ``(like_tree, meta, step)``."""
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = _leaves_with_paths(like_tree)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    paths = {p for p, _ in pairs}
    if paths != set(by_path):
        missing = paths - set(by_path)
        extra = set(by_path) - paths
        raise ValueError(f"checkpoint/tree mismatch: missing="
                         f"{sorted(missing)[:4]} extra={sorted(extra)[:4]}")
    for p, like in pairs:
        if not isinstance(like, torch.Tensor):
            raise TypeError(f"{p}: restore fills tensors in place, got "
                            f"{type(like).__name__}")
        arr = np.load(os.path.join(src, by_path[p]["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{p}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        like.copy_(torch.from_numpy(arr))
    return like_tree, manifest["meta"], manifest["step"]


def _tile_key(name: str, idx: tuple[int, ...]) -> str:
    return f"{name}|{','.join(str(i) for i in idx)}"


def save_tiles(directory: str, epoch: int, arrays: dict, *,
               meta: dict | None = None, async_save: bool = False):
    """Checkpoint the tiles of named ``BlockArray``s at one epoch.

    ``arrays`` maps a stable name to a BlockArray; the same names (and
    geometries) must be passed to :func:`restore_tiles`.  Returns the
    committed path, or the committing thread when ``async_save`` (join
    it — or call ``latest_epoch`` — before trusting the epoch on disk).
    """
    per_home: dict[int, dict[str, np.ndarray]] = {}
    manifest: dict[str, Any] = {"epoch": epoch, "meta": meta or {},
                                "arrays": {}}
    for name, ba in arrays.items():
        manifest["arrays"][name] = {
            "shape": list(ba.shape), "block_shape": list(ba.block_shape),
            "dtype": dtype_name(ba.dtype),
            "tiles": int(np.prod(ba.grid))}
        for idx in ba.block_indices():
            home = ba.home.get(idx, 0)
            # a copy on the host, so the writer never reads a tile the
            # serving loop may still hold
            per_home.setdefault(home, {})[_tile_key(name, idx)] = \
                ba.get_tile(idx).to("cpu", copy=True).numpy()
    manifest["homes"] = sorted(per_home)

    def write():
        out = os.path.join(directory, f"epoch_{epoch:08d}")
        tmp = out + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        writers = [threading.Thread(
            target=lambda h=h, tiles=tiles: np.savez(
                os.path.join(tmp, f"home_{h}.npz"), **tiles),
            daemon=True, name=f"ckpt-home-{h}")
            for h, tiles in per_home.items()]
        for t in writers:
            t.start()
        for t in writers:
            t.join()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(out, ignore_errors=True)
        os.replace(tmp, out)
        return out

    if async_save:
        t = threading.Thread(target=write, daemon=True,
                             name=f"ckpt-epoch-{epoch}")
        t.start()
        return t
    return write()


def latest_epoch(directory: str) -> int | None:
    """Newest *committed* tile-checkpoint epoch under ``directory``
    (None when there is none — a crash mid-write leaves no marker)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "_COMMITTED")):
            e = int(m.group(1))
            best = e if best is None else max(best, e)
    return best


def restore_tiles(directory: str, arrays: dict, *,
                  epoch: int | None = None) -> tuple[int, dict]:
    """Load tiles back into registered ``BlockArray``s (the geometry must
    match the manifest); ``epoch=None`` means the latest committed one.
    Each tile is written through ``set_tile`` onto the array's device in
    the array's dtype.  Returns ``(epoch, meta)``."""
    if epoch is None:
        epoch = latest_epoch(directory)
        if epoch is None:
            raise FileNotFoundError(
                f"no committed tile checkpoint under {directory!r}")
    src = os.path.join(directory, f"epoch_{epoch:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    want = set(manifest["arrays"])
    have = set(arrays)
    if want != have:
        raise ValueError(f"checkpoint/arrays mismatch: "
                         f"missing={sorted(want - have)[:4]} "
                         f"extra={sorted(have - want)[:4]}")
    for name, ba in arrays.items():
        spec = manifest["arrays"][name]
        if list(ba.shape) != spec["shape"] or \
                list(ba.block_shape) != spec["block_shape"]:
            raise ValueError(
                f"{name}: geometry {ba.shape}/{ba.block_shape} != "
                f"checkpoint {tuple(spec['shape'])}/"
                f"{tuple(spec['block_shape'])}")
    loaded: dict[str, np.ndarray] = {}
    for h in manifest["homes"]:
        with np.load(os.path.join(src, f"home_{h}.npz")) as z:
            loaded.update({k: z[k] for k in z.files})
    for name, ba in arrays.items():
        for idx in ba.block_indices():
            tile = loaded[_tile_key(name, idx)]
            ba.set_tile(idx, torch.as_tensor(tile).to(ba.device, ba.dtype))
    return epoch, manifest["meta"]
