"""Epoch-tagged per-home ``BlockArray`` tile checkpoints (the serving
session's shared state).

The layout and the ``.npz`` keys are the JAX package's
(``src/repro/ckpt/checkpoint.py``), so a checkpoint written by either
package restores in the other::

    <dir>/epoch_<e>/manifest.json    # array geometry, homes, meta
    <dir>/epoch_<e>/home_<h>.npz     # "<name>|i,j" -> tile (npy inside)
    <dir>/epoch_<e>/_COMMITTED       # written last -> crash-safe commit

Tiles are snapshotted to host memory synchronously (one device-to-host
copy per tile), then each home's file is written by its own daemon
thread.  ``np.savez`` stores raw npy records: the round trip is
bit-identical.
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

from ..core.blocks import dtype_name

__all__ = ["save_tiles", "latest_epoch", "restore_tiles"]


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
