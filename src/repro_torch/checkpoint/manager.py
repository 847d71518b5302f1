"""Fault-tolerant checkpointing (the port's copy of
``repro.checkpoint.manager``, in ``repro``'s on-disk layout).

  * **Layout** — ``<dir>/step_<N:010d>/arrays.npz`` holds every leaf of the
    state tree under its ``/``-joined path, and ``meta.json`` its shape and
    dtype name beside the caller's ``extra``; ``<dir>/LATEST`` names the
    newest step. A checkpoint written by ``repro`` restores here, and one
    written here restores in ``repro``: bfloat16 leaves are stored as
    ``np.savez`` stores ``repro``'s ml_dtypes arrays, raw 2-byte ``|V2``
    records, and rebuilt through their bit pattern from ``meta.json``'s
    dtype.
  * **Atomic commits** — a checkpoint is written to ``step_<N>.tmp`` and
    renamed only when complete; ``LATEST`` is replaced last.
  * **Async** — ``save(..., blocking=False)`` snapshots to host memory on
    the caller's thread (a copy: the trainer updates its tensors in place)
    and hands the file writes to a writer thread.
  * **Retention** — keep the ``keep`` most recent checkpoints, never the
    one ``LATEST`` names.
  * **Preemption hook** — ``install_sigterm_handler`` flushes a final
    checkpoint on SIGTERM.
  * **Across ranks** — under a ranked plan, with ``specs`` (the parameters'
    ArraySpec tree, which the optimizer state mirrors), ``save`` gathers
    every leaf whole onto rank 0, which alone writes, and ``restore`` reads
    the full leaves on every rank and keeps each rank's shard under the
    current plan. A checkpoint therefore does not depend on the mesh: a run
    saved on one factorisation of the ranks resumes on another.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import signal
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import gather_leaf, mirror_specs, ranked_plan, shard_leaf, spec_items
from repro_torch.utils.logging import get_logger
from repro_torch.utils.trees import tree_items

log = get_logger("checkpoint")

def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` as ``np.savez`` should store it: bfloat16 as
    raw ``|V2`` records of its bit pattern, everything else as itself."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view("V2")
    return t.to("cpu", copy=True).numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A CPU tensor of the stored array ``arr`` whose ``meta.json`` dtype is
    ``dtype_name``: 2-byte records of a bfloat16 leaf (``|V2``, or an
    ml_dtypes array) through their bit pattern."""
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name)))


class CheckpointManager:
    """Save and restore state trees (nested dicts of tensors) under
    ``directory`` (see the module docstring)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def latest_step(self) -> Optional[int]:
        """The step ``LATEST`` names, or None before the first commit."""
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip())

    def all_steps(self) -> List[int]:
        """The committed steps, ascending."""
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                steps.append(int(d[5:]))
        return sorted(steps)

    # -- save ------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict] = None, blocking: bool = True,
             specs=None):
        """Snapshot ``state`` (a tree of tensors) at ``step``; across ranks
        (``specs`` given) every rank calls it and rank 0 writes the whole
        leaves."""
        if self._error:
            raise RuntimeError("async checkpoint writer failed") from self._error
        names = [name for name, _ in tree_items(state)]
        leaves = dict(tree_items(state))
        plan = ranked_plan() if specs is not None else None
        writer = True
        if plan is None:
            # snapshot on the caller's thread: device -> host copies
            host = {name: _to_host(leaves[name]) for name in names}
            shapes = {name: list(leaves[name].shape) for name in names}
        else:
            import torch.distributed as dist

            writer = dist.get_rank() == 0
            flat = dict(spec_items(mirror_specs(state, specs)))
            host, shapes = {}, {}
            for name in names:
                full = gather_leaf(leaves[name].detach(), plan, flat[name])
                shapes[name] = list(full.shape)
                if writer:
                    host[name] = _to_host(full)
                del full
        meta = {
            "step": step,
            "arrays": {
                name: {"shape": shapes[name], "dtype": _dtype_name(leaves[name])}
                for name in names
            },
            "extra": extra or {},
        }
        if not writer:
            return
        if blocking:
            self._write(step, host, meta)
        else:
            self._ensure_writer()
            self._q.put((step, host, meta))

    def _ensure_writer(self):
        if self._writer is None or not self._writer.is_alive():

            def run():
                while True:
                    item = self._q.get()
                    if item is None:
                        return
                    try:
                        self._write(*item)
                    except BaseException as e:  # pragma: no cover
                        self._error = e
                        log.error("async checkpoint write failed: %s", e)

            self._writer = threading.Thread(target=run, daemon=True)
            self._writer.start()

    def wait(self):
        """Barrier for pending async saves (across ranks: for rank 0's, on
        every rank)."""
        if self._writer and self._writer.is_alive():
            self._q.put(None)
            self._writer.join()
            self._writer = None
        if self._error:
            raise RuntimeError("async checkpoint writer failed") from self._error
        plan = ranked_plan()
        if plan is not None and not plan.mesh.virtual:
            import torch.distributed as dist

            dist.barrier()

    def _write(self, step: int, host: Dict[str, np.ndarray], meta: Dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"), os.path.join(self.dir, "LATEST"))
        self._gc()
        log.info("checkpoint step %d committed", step)

    def _gc(self):
        steps = self.all_steps()
        latest = self.latest_step()
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            if s == latest:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, target, step: Optional[int] = None, specs=None):
        """Restore into ``target`` (a tree of tensors): each leaf read by its
        path and copied IN PLACE into the target leaf (cast to its dtype, on
        its device), so a restore never holds two copies of the state on
        the card. Across ranks (``specs`` given) each full leaf is cut to
        this rank's shard under the current plan first. Returns
        (``target``, step)."""
        plan = ranked_plan() if specs is not None else None
        flat = dict(spec_items(mirror_specs(target, specs))) if plan is not None else {}
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            dtypes = {k: v["dtype"] for k, v in json.load(f)["arrays"].items()}
        with np.load(os.path.join(d, "arrays.npz")) as blob:
            missing = [n for n, _ in tree_items(target) if n not in blob]
            if missing:
                raise KeyError(f"checkpoint missing arrays: {missing[:5]} ...")
            with torch.no_grad():
                for name, tgt in tree_items(target):
                    src = _from_host(blob[name], dtypes[name])
                    if plan is not None:
                        src = shard_leaf(src, plan, flat[name], plan.mesh.coords)
                    if tuple(src.shape) != tuple(tgt.shape):
                        raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, "
                                         f"target {tuple(tgt.shape)}")
                    tgt.copy_(src)
        return target, step

    def read_extra(self, step: Optional[int] = None) -> Dict:
        """The ``extra`` dict saved with ``step`` (default the latest)."""
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)["extra"]


def install_sigterm_handler(fn: Callable[[], None]):
    """Preemption path: flush a checkpoint before the scheduler kills us."""

    def handler(signum, frame):  # pragma: no cover - signal path
        log.warning("SIGTERM received — writing preemption checkpoint")
        fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
