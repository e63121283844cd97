"""Fault-tolerant checkpointing: atomic, LEXI-compressed, mesh-shape
independent (ports ``repro/train/checkpoint.py``; the two packages read
each other's checkpoints).

Layout (one directory per step):

    <dir>/step_000123/
        MANIFEST.json        leaf shapes, dtypes, codecs, per-leaf sha256,
                             step metadata
        leaf_00000.lexi      LEXI-H container (bf16 leaves, bit-exact)
        leaf_00001.lexi32    LEXI-F32 container (f32 leaves)
        leaf_00002.npy       raw bytes (small or integer leaves)
    <dir>/LATEST             text file: last complete step directory name

Leaves are the whole (logical) arrays, numbered in JAX's flattening order
(``core.tree``: a ``TrainState`` flattens to the params, then the step,
master, m and v, dict keys sorted), so ``leaf_NNNNN`` is the same leaf in
both packages and every leaf file and manifest entry is byte-identical
to the reference's for the same state.  bf16 goes through its uint16 bits
(no ``ml_dtypes``); the manifest names it ``"bfloat16"``.  The manifest's
``treedef`` is the reference's JAX tree description there and the word
``repro_torch`` here; neither package's ``restore`` reads it.

Atomicity: written to ``<dir>/.tmp_step_x``, fsync'd, then renamed; LATEST
is updated last, so a crash mid-write never corrupts the restore point.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import bitstream, tree

_NP_DTYPES = {torch.float32: "float32", torch.int32: "int32",
              torch.int64: "int64", torch.float64: "float64",
              torch.uint8: "uint8"}


def _to_numpy(leaf: torch.Tensor):
    """(numpy array, dtype string); bf16 as its uint16 bits."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NP_DTYPES[t.dtype]


def _fsync_write(path: str, data) -> None:
    with open(path, "wb" if isinstance(data, bytes) else "w") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


def save(ckpt_dir: str, step: int, state: Any) -> str:
    """Atomically write a checkpoint of ``state`` (a tree of whole
    tensors); returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp_{name}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = tree.leaves(state)
    manifest: Dict[str, Any] = {
        "step": step, "treedef": "repro_torch", "n_leaves": len(leaves),
        "leaves": [], "extra": {},
    }
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        entry: Dict[str, Any] = {"shape": list(arr.shape), "dtype": dtype}
        if dtype == "bfloat16" and arr.size >= 4096:
            blob = bitstream.compress_bf16(arr)
            fn = f"leaf_{i:05d}.lexi"
            entry["codec"] = "lexi-h"
        elif dtype == "float32" and arr.size >= 4096:
            blob = bitstream.compress_f32(arr)
            fn = f"leaf_{i:05d}.lexi32"
            entry["codec"] = "lexi-f32"
        else:
            blob = arr.tobytes()
            fn = f"leaf_{i:05d}.npy"
            entry["codec"] = "raw"
        entry["stored_bytes"] = len(blob)
        entry["file"] = fn
        entry["sha256"] = hashlib.sha256(blob).hexdigest()
        _fsync_write(os.path.join(tmp, fn), blob)
        manifest["leaves"].append(entry)
    _fsync_write(os.path.join(tmp, "MANIFEST.json"), json.dumps(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_write(os.path.join(ckpt_dir, "LATEST"), name)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        name = fh.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "MANIFEST.json")):
        return None
    return int(name.split("_")[1])


def _leaf(blob: bytes, entry: Dict) -> torch.Tensor:
    shape = tuple(entry["shape"])
    if entry["codec"] == "lexi-h":
        u16 = bitstream.decompress_bf16(blob)
        return torch.from_numpy(u16.view(np.int16).copy()) \
            .view(torch.bfloat16).reshape(shape)
    if entry["codec"] == "lexi-f32":
        return torch.from_numpy(bitstream.decompress_f32(blob).copy()) \
            .reshape(shape)
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(np.frombuffer(blob, np.int16).copy()) \
            .view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(blob, np.dtype(entry["dtype"]))
                            .copy()).reshape(shape)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None) -> Any:
    """Load into the structure of ``like`` (leaves with the whole shapes,
    any device: e.g. ``meta`` tensors); CPU tensors out."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    like_leaves = tree.leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the state {len(like_leaves)}")
    out = []
    for entry, ref in zip(manifest["leaves"], like_leaves):
        with open(os.path.join(d, entry["file"]), "rb") as fh:
            blob = fh.read()
        if hashlib.sha256(blob).hexdigest() != entry["sha256"]:
            raise IOError(f"checksum mismatch for {entry['file']}")
        arr = _leaf(blob, entry)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{entry['file']}: shape {tuple(arr.shape)}, "
                             f"the state's {tuple(ref.shape)}")
        out.append(arr)
    return tree.unflatten(like, out)


def stored_size(ckpt_dir: str, step: int) -> Dict[str, int]:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    itemsize = {"bfloat16": 2, "float32": 4, "float64": 8, "int32": 4,
                "int64": 8, "uint8": 1}
    raw = sum(int(np.prod(e["shape"])) * itemsize[e["dtype"]]
              for e in manifest["leaves"])
    stored = sum(e["stored_bytes"] for e in manifest["leaves"])
    return {"raw_bytes": raw, "stored_bytes": stored}
