"""Asynchronous checkpointing with retention and resume (the port of
``repro.checkpoint.manager``), in the reference's on-disk format.

A checkpoint is a directory ``step_XXXXXXXX`` holding ``manifest.json``
(``step``, ``time`` and, for each leaf, its ``file``, ``shape`` and
``dtype``) and one ``.npy`` file per leaf, named by the leaf's flattened
path (``opt/m/final_norm/scale`` -> ``opt__m__final_norm__scale.npy``).
Paths follow JAX's flattening (sorted dict keys, list indices), so the
port's manager and the reference's read each other's directories.

* ``save`` stages every leaf on the host now (device -> host copy) and
  serializes on a background thread; one write is in flight at a time, and
  a failed write raises at the next ``wait``/``save``.  A step is written
  to ``step_XXXXXXXX.tmp`` and renamed, so a reader never sees half of it;
  retention keeps the newest ``keep``.
* bfloat16 leaves: numpy has no bf16, and the reference's ``np.save`` of
  an ``ml_dtypes`` array writes its 16 raw bits under the descr ``'<V2'``,
  with ``"bfloat16"`` in the manifest.  The port writes the same bytes
  (its own ``.npy`` header, descr ``'<V2'``) and reads them back as raw
  bits, typed by the manifest, without ``ml_dtypes`` and never through
  float32, so a bf16 leaf survives bit for bit.
* ``restore`` returns torch tensors in the structure of ``like`` (a tree
  of tensors or arrays; only shapes are read, so ``meta`` tensors will do)
  and raises ``ValueError`` on a shape mismatch.  ``shardings``, as in
  the reference, places each leaf: here a tree of devices (the port has
  no mesh); by default a leaf goes to its ``like`` leaf's device (the CPU
  for arrays and ``meta`` tensors).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .._tree import flatten_with_path, leaves, unflatten

BF16_DESCR = "<V2"


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of one leaf, on the host now."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":      # an ml_dtypes array, as the reference holds
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {key: _host(leaf) for key, leaf in flatten_with_path(tree)}


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)                   # a fresh, writable array
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Stage `state` (device -> host) now; serialize in the background."""
        self.wait()                      # one in-flight checkpoint at a time
        staged = _flatten(state)

        def write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                tmp.mkdir(parents=True, exist_ok=True)
                manifest = {"step": step, "time": time.time(),
                            "arrays": {}}
                for key, (arr, dtype) in staged.items():
                    fn = key.replace("/", "__") + ".npy"
                    _save_npy(tmp / fn, arr, dtype)
                    manifest["arrays"][key] = {
                        "file": fn, "shape": list(arr.shape),
                        "dtype": dtype}
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._retain()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_write and not blocking:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}") from err

    def _retain(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") and \
                    (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                shardings: Any = None) -> Any:
        """Restore into the structure of `like` (each leaf on its device)."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_like = flatten_with_path(like)
        flat_sh = (leaves(shardings) if shardings is not None
                   else [None] * len(flat_like))
        out = []
        for (key, leaf), sh in zip(flat_like, flat_sh):
            entry = manifest["arrays"][key]
            t = _load(d / entry["file"], entry["dtype"])
            if list(t.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            if sh is None and isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
                sh = leaf.device
            out.append(t if sh is None else t.to(sh))
        return unflatten(like, out)

    def restore_latest(self, like: Any, shardings: Any = None
                       ) -> tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like, shardings)
