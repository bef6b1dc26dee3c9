"""Atomic, async-capable checkpointing in the reference's on-disk format.

Layout:  <dir>/step_<n:010d>/
             manifest.json          step, keys (shape, dtype), extra,
                                    n_processes, checksums
             shard_0.npz            every array (np.savez)
             COMMITTED              empty marker written last (atomic rename)

The format is the JAX package's (``repro.ft.checkpoint``) to the key: key
paths join dict keys (in sorted order) and sequence indices with ``"/"``, as
``jax.tree_util.tree_flatten_with_path`` names them, so a checkpoint written
by either package loads in the other. This package is one process (its
``Mesh`` is one process over its devices), so it writes ``shard_0.npz`` and
``n_processes = 1``; it reads as many shards as a manifest lists.

- Writes go to ``step_<n>.tmp`` then a single ``os.rename`` commits — a
  killed writer never leaves a half-readable checkpoint.
- Integrity: the manifest records a CRC32 per shard file; reads verify it
  and a corrupt (or unreadable) step FALLS BACK to the newest intact
  earlier committed step with a warning instead of crashing. (Checkpoints
  written before checksums existed load unverified.)
- ``save_async`` snapshots to host memory synchronously and does the file
  I/O on a daemon thread. A failed async write re-raises on the next
  ``wait()``/``save``/``save_async``.
- Fault-injection seams (``repro_torch.ft.faults``): ``checkpoint.write``
  fires before the shard write (a torn write: tmp dir, no COMMITTED marker
  — invisible to readers), ``checkpoint.read`` per step read (exercises the
  fallback walk).
- ``restore(target)`` takes a tree of tensors (or arrays) and places each
  leaf on the target leaf's device and dtype. ``restore_blind`` hands back
  nested dicts of numpy arrays: store snapshots come back that way and the
  loading store re-places each key by its own policy, so a checkpoint
  written under one mesh shape restores onto any other.
- bfloat16: numpy has no such type, so a bfloat16 leaf is stored as the
  reference stores it: its bits as numpy's 2-byte void type (``|V2``),
  with ``"dtype": "bfloat16"`` in the manifest. ``restore`` turns such a
  leaf back into ``torch.bfloat16`` bit for bit (or, for an array target,
  into the target's dtype through an exact float32). The reference itself
  cannot restore these leaves (its ``astype`` has no cast from ``|V2``).
- A synopsis checkpoint (``VerdictEngine.save_synopses``) holds one
  ``"agg<k>-measure<m>"`` subtree per synopsis and, when the engine has a
  workload-intelligence plane, the reserved ``"intel"`` subtree: one
  ``"intel/blob"`` uint8 array, the canonical JSON of the answer cache,
  the router and the counters (``repro_torch.intel``), byte for byte the
  JAX package's layout.

Trees are nested dicts, lists and tuples; ``None`` is an empty subtree;
every other value is a leaf (a tensor, an array or a number).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.ft import faults

_SEP = "/"


class CheckpointCorruptError(RuntimeError):
    """A committed step failed checksum/readback verification."""


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _flatten(tree):
    """``{"a/0/b": leaf}`` in the reference's key-path naming and order."""
    return {_SEP.join(str(p) for p in path): leaf
            for path, leaf in _leaves(tree)}


def _map(fn, tree, prefix=()):
    """The tree with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(str(p) for p in prefix), tree)


_BF16_BITS = np.dtype("V2")  # a bfloat16 leaf's bits on disk


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
            return x.view(torch.int16).numpy().view(_BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(a: np.ndarray) -> str:
    """The manifest's dtype of a host leaf (the reference's names)."""
    return "bfloat16" if a.dtype == _BF16_BITS else str(a.dtype)


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """The bfloat16 tensor whose bits a ``|V2`` array holds (a copy)."""
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._async_exc: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()  # serialize with any in-flight async save
        self._write(step, _map(lambda _, x: _host(x), tree), extra or {})

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _map(lambda _, x: np.array(_host(x)), tree)

        def run():
            try:
                self._write(step, host_tree, extra or {})
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._async_exc = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join any in-flight async save; re-raise its failure here.

        A failed background write must never vanish on the daemon thread —
        the NEXT synchronization point (``wait``/``save``/``save_async``)
        raises it, so callers learn a step is missing before relying on it.
        """
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._async_exc = self._async_exc, None
        if exc is not None:
            raise RuntimeError("async checkpoint save failed") from exc

    def _write(self, step: int, host_tree, extra: dict):
        flat = _flatten(host_tree)
        proc = 0  # one process
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        # Injected torn write: tmp dir exists, no COMMITTED marker, never
        # renamed — invisible to all_steps()/readers by construction.
        faults.fire("checkpoint.write", key=f"step_{step}")
        shard_name = f"shard_{proc}.npz"
        np.savez(os.path.join(tmp, shard_name), **flat)
        with open(os.path.join(tmp, shard_name), "rb") as f:
            crc = zlib.crc32(f.read())
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                     for k, v in flat.items()},
            "extra": extra,
            "n_processes": 1,
            "checksums": {shard_name: crc},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, "COMMITTED"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(full, "COMMITTED")):
                out.append(int(name[5:]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int):
        """Load ONE committed step, verifying per-shard checksums."""
        faults.fire("checkpoint.read", key=f"step_{step}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        # Absent in checkpoints written before integrity checking: load
        # unverified rather than refuse old knowledge.
        checksums = manifest.get("checksums", {})
        data = {}
        for p in range(manifest["n_processes"]):
            shard_name = f"shard_{p}.npz"
            with open(os.path.join(path, shard_name), "rb") as f:
                raw = f.read()
            want = checksums.get(shard_name)
            if want is not None and zlib.crc32(raw) != int(want):
                raise CheckpointCorruptError(
                    f"checksum mismatch in {path}/{shard_name}")
            with np.load(io.BytesIO(raw)) as z:
                for k in z.files:
                    data[k] = z[k]
        return data, manifest

    def _read_step(self, step: Optional[int]):
        """Newest intact committed step ≤ ``step`` (or newest overall).

        A corrupt/unreadable step WARNS and falls back to the next-newest
        committed step — restore degrades to older knowledge rather than
        crashing (the synopsis is an accelerator, not the source of truth).
        Raises only when no intact step remains.
        """
        steps = self.all_steps()
        candidates = [s for s in reversed(steps)
                      if step is None or s <= step]
        if not candidates:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        last_exc: Optional[BaseException] = None
        for s in candidates:
            try:
                return self._load_step(s)
            except Exception as e:  # noqa: BLE001 — walk back, warn
                last_exc = e
                warnings.warn(
                    f"checkpoint step {s} unreadable ({e!r}); falling back "
                    f"to an earlier committed step",
                    RuntimeWarning, stacklevel=2,
                )
        raise CheckpointCorruptError(
            f"no intact committed checkpoint in {self.dir} "
            f"(last error: {last_exc!r})")

    def restore_blind(self, step: Optional[int] = None):
        """Restore without a target tree: nested dicts straight from the
        manifest key paths, leaves as host numpy arrays. Returns
        ``(tree, extra)``.

        This is how state whose shapes are unknown before restore comes back
        — the synopsis snapshots (``VerdictEngine.load_synopses``), whose
        row counts are a property of what past sessions learned.

        A bfloat16 leaf comes back as stored: its bits, a ``|V2`` array
        (``torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)`` is
        the tensor).
        """
        data, manifest = self._read_step(step)
        tree: dict = {}
        for key, arr in data.items():
            node = tree
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        return tree, manifest["extra"]

    def restore(self, target: Any, step: Optional[int] = None):
        """Restore into the structure of ``target``; returns (tree, extra).

        A tensor leaf of ``target`` comes back as a tensor on that leaf's
        device with its dtype; an array leaf as an array of its dtype; any
        other leaf as the stored array. A stored bfloat16 leaf (``|V2``
        bits) becomes a bfloat16 tensor bit for bit before it is cast.
        """
        data, manifest = self._read_step(step)
        missing = set(_flatten(target)) - set(data)
        if missing:
            raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

        def place(key, leaf):
            arr = data[key]
            bf16 = manifest["keys"].get(key, {}).get("dtype") == "bfloat16" \
                and arr.dtype == _BF16_BITS
            if isinstance(leaf, torch.Tensor):
                t = _bf16_tensor(arr) if bf16 else torch.as_tensor(arr)
                return t.to(device=leaf.device, dtype=leaf.dtype)
            if bf16:
                arr = _bf16_tensor(arr).float().numpy()
            if isinstance(leaf, np.ndarray):
                return arr.astype(leaf.dtype)
            return arr

        return _map(place, target), manifest["extra"]
