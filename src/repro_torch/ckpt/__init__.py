"""Checkpointing: atomic, async-capable, in the reference's on-disk format.

Layout (``repro.ckpt``'s, file for file): <dir>/step_<N>/
  meta.json               step, leaf paths, shapes, dtypes
  <flattened-path>.npy    one file per leaf ("/" in the path -> "__"),
                          bfloat16 stored as its uint16 bits

so a checkpoint written by either package restores into the other.

Atomicity: write into step_<N>.tmp, fsync, rename — a crash mid-save
leaves the previous checkpoint intact, and `latest_step` never sees a
.tmp directory.  Async: ``save(..., background=True)`` copies every leaf
to the host first (the only blocking part) and writes the files on a
worker thread.

On a mesh the state's leaves are DTensors: `to_host` gathers each whole
leaf (a collective: every rank calls it; `ft.Supervisor` does) and one
rank writes it (`write`), and `restore(..., shardings=)` places each
loaded leaf as its `NamedSharding` says on whatever mesh is up, each
rank keeping its block (the reference's elastic reshard: any mesh to any
mesh).  A DTensor template with no shardings is placed as the template.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.optim import flatten_with_paths, unflatten_like


def to_host(state) -> dict:
    """Every leaf of `state` as (numpy array, dtype name), by path; on a
    mesh every rank calls it (DTensor leaves are gathered whole)."""
    return {path: _to_host(leaf)
            for path, leaf in flatten_with_paths(state).items()}


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf -> (savable numpy array, dtype name): bfloat16 as a uint16
    view, as the reference stores it.  A DTensor is gathered whole."""
    t = t.detach()
    if sharding.is_dtensor(t):
        t = t.full_tensor()
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir, step: int, state, *, background: bool = False,
         keep: int = 3) -> Optional[threading.Thread]:
    """Checkpoint `state` (a nested dict of tensors) at `step`; returns
    the writer thread when `background`."""
    return write(ckpt_dir, step, to_host(state), background=background,
                 keep=keep)


def write(ckpt_dir, step: int, host: dict, *, background: bool = False,
          keep: int = 3) -> Optional[threading.Thread]:
    """Write `to_host`'s leaves as the checkpoint of `step`."""
    ckpt_dir = pathlib.Path(ckpt_dir)

    def _write():
        tmp = ckpt_dir / f"step_{step}.tmp"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = {"step": step, "leaves": {}}
        for path, (arr, dname) in host.items():
            fn = path.replace("/", "__") + ".npy"
            np.save(tmp / fn, arr)
            meta["leaves"][path] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": dname}
        (tmp / "meta.json").write_text(json.dumps(meta))
        for f in tmp.iterdir():                     # durability before rename
            fd = os.open(f, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _gc(ckpt_dir, keep)

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, template, shardings=None):
    """Load `step` into the structure of `template`, each leaf on the
    device of the template's leaf at that path: placed by `shardings` (a
    matching tree of `sharding.NamedSharding`, leaves it lacks restored
    whole) as a DTensor, or as a DTensor template leaf is placed."""
    from torch.distributed.tensor import distribute_tensor
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((d / "meta.json").read_text())
    flat_s = flatten_with_paths(shardings) if shardings is not None else {}
    out = {}
    for path, like in flatten_with_paths(template).items():
        info = meta["leaves"][path]
        t = _from_savable(np.load(d / info["file"]), info["dtype"])
        if list(t.shape) != info["shape"]:
            raise ValueError(f"{path}: file shape {list(t.shape)} vs "
                             f"meta {info['shape']}")
        sh = flat_s.get(path)
        if sh is not None:
            dev = like.to_local().device if sharding.is_dtensor(like) \
                else like.device
            out[path] = sharding.wrap_block(sh.local(t).to(dev), sh, t.shape)
        elif sharding.is_dtensor(like):
            out[path] = distribute_tensor(
                t.to(like.to_local().device), like.device_mesh,
                like.placements, src_data_rank=None)
        else:
            out[path] = t.to(like.device)
    return unflatten_like(template, out)
