"""Async sharded checkpoints: the port's counterpart of
:mod:`dquartic_tpu.train.orbax_ckpt`, selected as there by
``tpu.checkpoint_backend: "orbax"``.

It gives the JAX backend's three properties to the port's trainer:

* saves are async: ``save`` stages the state into host buffers (pinned
  memory, copied on the trainer's stream, for CUDA tensors) and returns;
  a background thread writes it while training goes on. A state saved
  before a step and loaded after it is the pre-step state bitwise. One
  snapshot is in flight at a time: a save of a new state first waits for
  the last one. A second save of the same snapshot (the best after the
  latest, in one epoch) does not wait: it is written after the first,
  from the same buffers (its shard files hard links of the first's);
* storage is sharded: every rank of the (dp 0, sp 0) replica writes its
  own file; under tp that is its shards of the split leaves (parameters,
  optimizer state, EMA); a replicated leaf is written once, by tp rank 0.
  No rank gathers a split leaf. The other replicas write nothing;
* the latest/best protocol and auto-resume are the JAX backend's: the
  latest save in a directory of its own name beside the best-model path
  (:data:`LATEST_NAME`), the best save at the best-model path itself.

The format is the port's own, not Orbax's: a directory holding
``meta.json`` (the format, the epoch, best loss, step, optimizer, the
saving mesh, and each leaf's split axis and whole shape) and one
``torch.save`` file of tensors per tp rank, ``shard-<i>-of-<n>.pt``.
A save writes into a temporary directory beside its final name; the lead
rank (mesh rank 0) gives it the final name only after every writing rank
has left its ``done`` marker, so a save that fails half-way leaves the
previous one loadable. An error in a writer is raised at the next
``save`` or ``wait``, never dropped. A resume reads each rank's own
shards on the same tp degree and reshards (the whole leaf from every
file, then the rank's cut) on another.

Only the trainer's resume reads this format, as only the JAX trainer
reads Orbax trees; ``predict`` and ``convert-checkpoint`` read single
files. The port does not read a JAX Orbax tree: where one lies at the
latest or the best path, training raises and writes nothing there.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

FORMAT = "dquartic_tpu_torch async sharded checkpoint"
VERSION = 1
LATEST_NAME = "dquartic_latest_checkpoint.shards"
# the JAX backend's latest name, and the files by which an Orbax tree is known
JAX_LATEST_NAME = "dquartic_latest_checkpoint.orbax"
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")
META = "meta.json"
# how long the lead waits for the other writers' markers
COMMIT_TIMEOUT_S = 3600.0

# {key: (tensor, split axis or None)}: a rank's leaves of the train state
Leaves = Dict[str, Tuple[torch.Tensor, Optional[int]]]


def shard_name(i: int, n: int) -> str:
    return f"shard-{i:05d}-of-{n:05d}.pt"


def is_orbax_tree(path: str) -> bool:
    """A directory the JAX package's Orbax backend wrote."""
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, m)) for m in ORBAX_MARKERS)


def refuse_orbax_trees(checkpoint_path: str) -> None:
    """Raise where a JAX Orbax tree lies at the JAX backend's latest path
    or at ``checkpoint_path``: the port neither resumes from one nor
    writes over it."""
    d = os.path.dirname(os.path.abspath(checkpoint_path))
    for path in (os.path.join(d, JAX_LATEST_NAME), os.path.abspath(checkpoint_path)):
        if is_orbax_tree(path):
            raise ValueError(
                f"{path} is a JAX Orbax checkpoint (the JAX package's tpu.checkpoint_backend "
                "'orbax'). The PyTorch port reads no Orbax trees and writes nothing over one: "
                "write a msgpack checkpoint from it with the JAX package (tpu.checkpoint_backend "
                "'msgpack'), which the port resumes from, or name another model.checkpoint_path")


def _remove(path: str) -> None:
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


@dataclasses.dataclass
class _Job:
    """One save: the staged snapshot written to ``final`` through ``tmp``."""

    final: str
    tmp: str
    meta: Optional[dict]
    staged: Dict[str, torch.Tensor]
    copied: Any = None  # the CUDA event after the staging copies
    after: Optional["_Job"] = None  # the job whose snapshot and files this one reuses
    thread: Optional[threading.Thread] = None
    error: Optional[BaseException] = None


class AsyncCheckpointBackend:
    """Latest/best checkpoint pair with async, sharded writes on ``mesh``
    (None: one process). Every rank of the mesh calls :meth:`save`,
    :meth:`wait` and :meth:`load` at the same points of the loop."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        m = mesh
        self.writes = m is None or (m.dp_rank == 0 and m.sp_rank == 0)
        self.lead = m is None or m.rank == 0
        self.file_index = 0 if m is None else m.tp_rank
        self.n_files = 1 if m is None else m.tp
        self._jobs: List[_Job] = []
        self._buffers: Dict[str, torch.Tensor] = {}
        self._last: Optional[_Job] = None
        self._seq = 0

    # ------------------------------------------------------------------ #
    # paths                                                              #
    # ------------------------------------------------------------------ #

    def latest_path_for(self, checkpoint_path: str) -> str:
        d = os.path.dirname(os.path.abspath(checkpoint_path))
        return os.path.join(d, LATEST_NAME)

    # ------------------------------------------------------------------ #
    # save                                                               #
    # ------------------------------------------------------------------ #

    def save(self, path: str, header: Dict[str, Any], leaves: Optional[Leaves] = None) -> None:
        """Stage this rank's ``leaves`` and write them to ``path`` in the
        background, with ``header`` (numbers) in its ``meta.json``.
        ``leaves=None`` saves the last save's snapshot again, without
        waiting for it. A rank of another replica than (dp 0, sp 0) writes
        nothing."""
        if not self.writes:
            return
        path = os.path.abspath(path)
        refuse_orbax_trees(path)
        if leaves is None and self._last is None:
            raise ValueError("no earlier save to save again")
        if leaves is not None:
            self._finish()  # one snapshot in flight: its buffers are reused
        self._seq += 1
        tmp = f"{path}.tmp-{self._seq}"
        if leaves is None:
            last = self._last
            job = _Job(path, tmp, last.meta and dict(last.meta, **header), last.staged,
                       after=last)
        else:
            staged, copied = self._stage(self._mine(leaves))
            meta = self._meta(header, leaves) if self.lead else None
            job = _Job(path, tmp, meta, staged, copied)
        job.thread = threading.Thread(target=self._write, args=(job,), daemon=True,
                                      name="async-checkpoint")
        self._jobs.append(job)
        self._last = job
        job.thread.start()

    def _mine(self, leaves: Leaves) -> Leaves:
        """The leaves this rank writes: its shards, and the replicated
        leaves on tp rank 0."""
        return {k: v for k, v in leaves.items() if v[1] is not None or self.file_index == 0}

    def prepare(self, leaves: Leaves) -> None:
        """Make the host buffers of this rank's leaves now (pinned memory
        takes seconds to allocate for gigabytes), so that no save of the
        loop waits for them."""
        if self.writes:
            for key, (t, _) in self._mine(leaves).items():
                self._buffer(key, t)

    def _buffer(self, key: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._buffers[key] = buf
        return buf

    def _meta(self, header: Dict[str, Any], leaves: Leaves) -> dict:
        n = self.n_files
        layout = {}
        for key, (t, axis) in leaves.items():
            shape = list(t.shape)
            if axis is not None:
                shape[axis] *= n
            layout[key] = {"axis": axis, "shape": shape}
        mesh = {"dp": 1, "sp": 1, "tp": 1} if self.mesh is None else dict(self.mesh.shape)
        return {"format": FORMAT, "version": VERSION, **header, "mesh": mesh,
                "files": [shard_name(i, n) for i in range(n)], "leaves": layout}

    def _stage(self, leaves: Leaves):
        """Copy the leaves into this backend's host buffers (made once, by
        :meth:`prepare` or here, pinned for CUDA tensors): on the current
        stream of a CUDA tensor, without waiting for the copies (the event
        returned marks their end), so the next in-place update runs after
        them."""
        staged = {}
        for key, (t, _) in leaves.items():
            buf = self._buffer(key, t)
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            staged[key] = buf
        copied = None
        if any(t.is_cuda for t, _ in leaves.values()):
            copied = torch.cuda.Event()
            copied.record()
        return staged, copied

    def _write(self, job: _Job) -> None:
        """The writer thread: this rank's file, its marker, and on the lead
        the commit once every writer's marker is there."""
        mine = os.path.join(job.tmp, shard_name(self.file_index, self.n_files))
        try:
            if job.after is not None:
                job.after.thread.join()
            if job.copied is not None:
                job.copied.synchronize()
            os.makedirs(job.tmp, exist_ok=True)
            if not (job.after is not None and job.after.error is None and self._link(job, mine)):
                with open(mine, "wb") as f:
                    torch.save(job.staged, f)
                    f.flush()
                    os.fsync(f.fileno())
            _fsync_write(os.path.join(job.tmp, f"done-{self.file_index}"), "")
            if self.lead:
                self._commit(job)
        except BaseException as e:  # raised at the next save or wait
            job.error = e
            try:
                os.makedirs(job.tmp, exist_ok=True)
                _fsync_write(os.path.join(job.tmp, f"error-{self.file_index}"), repr(e))
            except OSError:
                pass

    def _link(self, job: _Job, mine: str) -> bool:
        """Hard-link this rank's file of the snapshot's earlier save (under
        its temporary or, once committed, its final name)."""
        name = shard_name(self.file_index, self.n_files)
        for d in (job.after.tmp, job.after.final):
            try:
                os.link(os.path.join(d, name), mine)
                return True
            except OSError:
                continue
        return False

    def _commit(self, job: _Job) -> None:
        """Wait for every writer's marker, write ``meta.json``, then swap the
        temporary directory in under the final name."""
        deadline = time.monotonic() + COMMIT_TIMEOUT_S
        while True:
            failed = sorted(glob.glob(os.path.join(job.tmp, "error-*")))
            if failed:
                with open(failed[0]) as f:
                    msg = f.read()
                raise RuntimeError(f"{job.final}: the writer of shard "
                                   f"{failed[0].rsplit('-', 1)[1]} failed: {msg}")
            missing = [i for i in range(self.n_files)
                       if not os.path.exists(os.path.join(job.tmp, f"done-{i}"))]
            if not missing:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job.final}: shards {missing} were not written in "
                                   f"{COMMIT_TIMEOUT_S:.0f} s")
            time.sleep(0.005)
        for i in range(self.n_files):
            os.remove(os.path.join(job.tmp, f"done-{i}"))
        _fsync_write(os.path.join(job.tmp, META), json.dumps(job.meta, indent=1))
        old = job.final + ".old"
        _remove(old)
        if os.path.lexists(job.final):
            os.replace(job.final, old)
        os.replace(job.tmp, job.final)
        _remove(old)

    def _finish(self) -> None:
        """Join every write in flight; raise the first error."""
        jobs, self._jobs = self._jobs, []
        for job in jobs:
            job.thread.join()
        for job in jobs:
            if job.error is not None:
                self._last = None
                raise RuntimeError(f"async checkpoint save to {job.final} failed") \
                    from job.error

    def wait(self) -> None:
        """Block until every save of this rank is written (and, on the lead,
        committed), then until every rank of the mesh is there; raise a
        writer's error."""
        err = None
        try:
            self._finish()
        except RuntimeError as e:
            err = e
        if self.mesh is not None and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            dist.barrier()
        if err is not None:
            raise err

    # ------------------------------------------------------------------ #
    # load                                                               #
    # ------------------------------------------------------------------ #

    def load(self, path: str, layout: Dict[str, Tuple[Tuple[int, ...], Optional[int]]],
             optional: Tuple[str, ...] = ()) -> Optional[Tuple[dict, Dict[str, torch.Tensor]]]:
        """``(meta, {key: this rank's tensor on the host})`` of the checkpoint
        at ``path`` for the leaves of ``layout`` (``{key: (this rank's
        shape, split axis or None)}``), or None where there is none. On the
        saving tp degree and axes each rank reads its own file (and the
        replicated leaves from file 0); otherwise it reshards. Keys
        starting with one of ``optional`` may be absent."""
        self.wait()
        path = os.path.abspath(path)
        refuse_orbax_trees(path)
        found = next((p for p in (path, path + ".old")
                      if os.path.exists(os.path.join(p, META))), None)
        if found is None:
            return None
        with open(os.path.join(found, META)) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{found}: not a {FORMAT} ({meta.get('format')!r})")
        n = len(meta["files"])
        tp = self.n_files
        rank = self.file_index
        files: Dict[int, Dict[str, torch.Tensor]] = {}

        def file(i):
            if i not in files:
                files[i] = torch.load(os.path.join(found, meta["files"][i]), map_location="cpu",
                                      mmap=True, weights_only=True)
            return files[i]

        out = {}
        for key, (shape, axis) in layout.items():
            leaf = meta["leaves"].get(key)
            if leaf is None:
                if key.startswith(optional):
                    continue
                raise ValueError(f"{found} holds no {key} (saved on mesh {meta['mesh']}; this "
                                 f"run's mesh {self._mesh_shape()})")
            whole = list(shape)
            if axis is not None:
                whole[axis] *= tp
            if whole != leaf["shape"]:
                raise ValueError(
                    f"{found}: {key} has the whole shape {tuple(leaf['shape'])} in the file "
                    f"(mesh {meta['mesh']}) and {tuple(whole)} here (mesh {self._mesh_shape()})")
            if leaf["axis"] == axis and (axis is None or n == tp):
                t = file(rank if axis is not None else 0)[key]
            else:  # another split: the whole leaf, then this rank's cut
                if leaf["axis"] is None:
                    t = file(0)[key]
                else:
                    t = torch.cat([file(i)[key] for i in range(n)], dim=leaf["axis"])
                if axis is not None:
                    s = shape[axis]
                    t = t.narrow(axis, rank * s, s)
            out[key] = t
        return meta, out

    def _mesh_shape(self) -> dict:
        return {"dp": 1, "sp": 1, "tp": 1} if self.mesh is None else dict(self.mesh.shape)

    def restore_or_init(self, checkpoint_path: str, layout, optional=()):
        """Auto-resume: ``(meta, tensors, epoch, best_loss, resumed)`` from
        the latest save beside ``checkpoint_path``, or ``(None, None, 0,
        inf, False)``."""
        refuse_orbax_trees(checkpoint_path)
        latest = self.latest_path_for(checkpoint_path)
        self.wait()  # no save of this run in flight on any rank
        if self.lead:  # the temporary directories of a run that died
            for path in (latest, os.path.abspath(checkpoint_path)):
                for stale in glob.glob(glob.escape(path) + ".tmp-*"):
                    _remove(stale)
        got = self.load(latest, layout, optional)
        if got is None:
            if self.lead:
                print(f"No checkpoint ({latest}) found. Starting from scratch.")
            return None, None, 0, float("inf"), False
        meta, tensors = got
        epoch, best_loss = int(meta["epoch"]), float(meta["best_loss"])
        if self.lead:
            print(f"Resumed from ({latest}) epoch {epoch}, best loss {best_loss:.6f}")
        return meta, tensors, epoch, best_loss, True
