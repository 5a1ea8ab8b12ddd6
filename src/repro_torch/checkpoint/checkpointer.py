"""Atomic, async checkpointing with verified restore.

Layout:   <dir>/step_<k>/
             manifest.json        (key paths, shapes, dtypes, crc32s, step,
                                   meta)
             arr_<i>.npy          (one file per leaf, full arrays)
          <dir>/LATEST            (atomic pointer file)

Trees are nested dicts whose leaves are arrays (numpy arrays, or tensors
on any device, which are copied to the host).  They are flattened depth
first in sorted-key order, the order in which JAX flattens a dict, so
``arr_<i>.npy`` holds the same leaf as in a snapshot of the same tree
written by the ``repro`` package.  The manifest names each leaf by its
key path (``"keys"``: one list of dict keys per leaf) beside the
reference's fields.  A manifest the reference wrote carries a JAX
``treedef`` proto instead, which this module does not parse: its reader
passes the key paths it expects (``restore(..., keys=)``, a function of
the manifest's meta and leaf count), and a manifest with neither raises
``ValueError``; the reader never guesses.  The limit runs one way: the
reference cannot read this module's manifests, which carry no
``treedef``.

Atomicity: write into step_<k>.tmp.<pid>, fsync, rename to step_<k>,
then rewrite LATEST via tmp+rename — a crash at any point leaves either
the old or the new checkpoint fully intact, never a torn one.

Integrity: every leaf blob carries a crc32 in the manifest
(``manifest_version: 2``); ``restore`` re-hashes the bytes it reads and
raises :class:`CorruptSnapshot` on mismatch.  v1 manifests (pre-checksum)
still restore — they simply skip verification.  When no explicit step is
requested, restore walks candidates newest-first (the ``LATEST``
designee first) and falls back past corrupt or half-deleted steps to the
newest snapshot that verifies, so a torn write or a stranded ``LATEST``
degrades to "recover the previous step", never to an unhandled error.

Crash recovery: :meth:`sweep_tmp` (run at construction) salvages
orphaned ``.tmp`` dirs — a complete, verified tmp whose final dir never
appeared is committed via the same rename; torn ones are deleted.

Async: ``save_async`` copies the tree to host memory (blocking, cheap)
then writes in a daemon thread; ``wait()`` joins before the next save
and re-raises the writer's exception (``wait(reraise=False)`` drains
without raising, for recovery paths).

A bfloat16 tensor, which has no numpy form, is stored bit for bit: its
16-bit patterns as a uint16 ``.npy``, named ``"bfloat16"`` in the
manifest as the reference names its bfloat16 leaves.  Restore returns
host (numpy) arrays, and a bfloat16 leaf as a CPU ``torch.bfloat16``
tensor; the caller places them on its device, or passes ``shardings=``
(one ``sharding.rules.NamedSharding``, or a tree of them shaped as the
checkpoint's): each leaf is then checked against its spec (an axis of
the spec's mesh a dim, dividing it) and returned as a host tensor.  The
single controller holds whole tensors on the mesh's merge device, and the
caller copies each leaf there into its own state (``runtime``'s
``load_state``), so a restore never holds a second copy of the state on
the device.  A sharding on another mesh than the one that saved the tree
is an elastic restore.  A sharded collection splits its arrays over
its shards itself (``store.router.ShardedCollection.restore``).

Fault sites (active only under an installed ``resilience.faults`` plan):
``snapshot.write.torn`` truncates a leaf file mid-write and simulates a
crash; ``snapshot.write.crash`` kills the writer between file
operations (stages: pre_manifest / pre_rename / post_rename /
post_latest); ``snapshot.read.corrupt`` flips a byte in the blob a
restore just read, which the crc check must catch.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from ..resilience import faults
from ..resilience.faults import SimulatedCrash

__all__ = ["Checkpointer", "CorruptSnapshot"]

MANIFEST_VERSION = 2

# tmp dirs currently being written by any Checkpointer in this process —
# sweep_tmp must not GC a sibling instance's in-flight write
_INFLIGHT_TMP: set[str] = set()
_INFLIGHT_LOCK = threading.Lock()


class CorruptSnapshot(RuntimeError):
    """A snapshot failed integrity verification (garbled manifest,
    checksum mismatch, or missing leaf file inside an existing step
    dir).  Carries ``step`` and ``file`` so fallback layers can log
    exactly what they skipped."""

    def __init__(self, step: int | None, file: str, reason: str):
        super().__init__(
            f"corrupt snapshot at step {step!r} ({file}): {reason}"
        )
        self.step = step
        self.file = file
        self.reason = reason


class _Bf16Bits(np.ndarray):
    """The 16-bit patterns of a bfloat16 tensor (numpy has no bfloat16):
    saved as uint16 and named ``"bfloat16"`` in the manifest."""


def _to_host(x, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array (a tensor is moved to the host first; a
    bfloat16 tensor as its bit patterns)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).numpy().view(np.uint16)
            return (np.array(bits) if copy else bits).view(_Bf16Bits)
        x = x.numpy()
    return np.array(x) if copy else np.asarray(x)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if isinstance(a, _Bf16Bits) else str(a.dtype)


def _from_bf16_bits(a: np.ndarray) -> torch.Tensor:
    """A bfloat16 leaf read back: any 2-byte array's bits as a CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)


def _host_tree(tree, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _host_tree(v, copy) for k, v in tree.items()}
    return _to_host(tree, copy)


def _flatten_with_paths(tree, prefix: tuple = ()):
    """(leaves, key paths) of a nested dict, depth first in sorted-key
    order (the order ``jax.tree.flatten`` gives a dict's children)."""
    if not isinstance(tree, dict):
        return [tree], [list(prefix)]
    leaves, paths = [], []
    for k in sorted(tree):
        if not isinstance(k, str):
            raise TypeError(f"snapshot tree keys must be str, got {k!r}")
        sub_leaves, sub_paths = _flatten_with_paths(tree[k], prefix + (k,))
        leaves += sub_leaves
        paths += sub_paths
    return leaves, paths


def _unflatten(paths, leaves):
    """The nested dict whose leaves are ``leaves`` at ``paths``."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf  # the whole tree is one leaf
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _sharding_at(shardings, path):
    """The sharding of the leaf at ``path``: one for every leaf, or the
    entry at the same key path of a tree of them."""
    node = shardings
    for k in path:
        if hasattr(node, "spec"):
            break
        if not isinstance(node, dict) or k not in node:
            raise ValueError(f"no sharding for the leaf {'/'.join(path)}")
        node = node[k]
    if not hasattr(node, "spec"):
        raise ValueError(f"no sharding for the leaf {'/'.join(path)}")
    return node


def _placed(leaf, sharding, path) -> torch.Tensor:
    """``leaf`` as a host tensor, after its spec is checked against its
    shape."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    shape = tuple(leaf.shape)
    if len(spec) > len(shape):
        raise ValueError(f"{'/'.join(path)}: spec {spec} has more entries than shape {shape}")
    for dim, ax in zip(shape, spec):
        names = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        size = 1
        for a in names:
            if a not in mesh.shape:
                raise ValueError(f"{'/'.join(path)}: the mesh has no axis {a!r}")
            size *= mesh.shape[a]
        if dim % size:
            raise ValueError(f"{'/'.join(path)}: dim {dim} does not split over {ax} ({size})")
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))


def _leaf_blob(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a.view(np.ndarray))
    return buf.getvalue()


def _tmp_owner_pid(name: str) -> int | None:
    try:
        return int(name.rsplit(".tmp.", 1)[1])
    except (IndexError, ValueError):
        return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._async_exc: BaseException | None = None
        # steps a restore() is mid-read on — _gc must skip them
        self._reading: set[int] = set()
        self._reading_lock = threading.Lock()
        self.sweep_tmp()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, meta: dict | None = None):
        self._write(step, _host_tree(tree), meta or {})

    def save_async(self, step: int, tree, meta: dict | None = None):
        self.wait()
        host_tree = _host_tree(tree, copy=True)  # snapshot now

        def _run():
            try:
                self._write(step, host_tree, meta or {})
            except BaseException as e:  # surfaced at the next wait()
                self._async_exc = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self, *, reraise: bool = True):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._async_exc = self._async_exc, None
        if exc is not None and reraise:
            raise exc

    def _write_file(self, path: str, blob: bytes, *, step: int):
        """Write one file, honouring the ``snapshot.write.torn`` site:
        when the plan fires it returns a byte offset — we persist the
        torn prefix exactly as an interrupted write would, then die."""
        name = os.path.basename(path)
        torn_at = faults.fire("snapshot.write.torn", file=name, step=step)
        with open(path, "wb") as f:
            if torn_at is not None:
                f.write(blob[: int(torn_at)])
                f.flush()
                os.fsync(f.fileno())
            else:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
        if torn_at is not None:
            raise SimulatedCrash(
                "snapshot.write.torn",
                f"torn write of {name} at byte {int(torn_at)}",
            )

    def _write(self, step: int, host_tree, meta: dict):
        leaves, paths = _flatten_with_paths(host_tree)
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp.{os.getpid()}"
        with _INFLIGHT_LOCK:
            _INFLIGHT_TMP.add(tmp)
        try:
            os.makedirs(tmp, exist_ok=True)
            blobs = [_leaf_blob(a) for a in leaves]
            manifest = {
                "manifest_version": MANIFEST_VERSION,
                "step": step,
                "meta": meta,
                "keys": paths,
                "leaves": [
                    {
                        "file": f"arr_{i}.npy",
                        "shape": list(a.shape),
                        "dtype": _dtype_name(a),
                        "crc32": zlib.crc32(blob),
                    }
                    for i, (a, blob) in enumerate(zip(leaves, blobs))
                ],
            }
            for i, blob in enumerate(blobs):
                self._write_file(
                    os.path.join(tmp, f"arr_{i}.npy"), blob, step=step
                )
            faults.fire("snapshot.write.crash", stage="pre_manifest", step=step)
            self._write_file(
                os.path.join(tmp, "manifest.json"),
                json.dumps(manifest).encode(),
                step=step,
            )
            faults.fire("snapshot.write.crash", stage="pre_rename", step=step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        finally:
            with _INFLIGHT_LOCK:
                _INFLIGHT_TMP.discard(tmp)
        faults.fire("snapshot.write.crash", stage="post_rename", step=step)
        self._update_latest(step)
        faults.fire("snapshot.write.crash", stage="post_latest", step=step)
        self._gc()

    def _update_latest(self, step: int):
        tmp = os.path.join(self.dir, f".LATEST.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self):
        steps = self.all_steps()
        with self._reading_lock:
            busy = set(self._reading)
        for s in steps[: -self.keep]:
            if s in busy:
                continue  # a concurrent restore is mid-read on this step
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ----------------------------------------------------------- tmp salvage
    def sweep_tmp(self):
        """Recover from a writer that died mid-snapshot: salvage
        complete, verified orphan ``.tmp`` dirs by committing the
        rename the crash pre-empted; delete torn ones.  Tmp dirs with a
        write in flight (this process) are left alone; so are tmps
        owned by a *different live* process (a concurrent writer)."""
        with _INFLIGHT_LOCK:
            inflight = set(_INFLIGHT_TMP)
        for name in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, name)
            if name.startswith(".LATEST.tmp."):
                os.unlink(path)
                continue
            if not (name.startswith("step_") and ".tmp." in name):
                continue
            if path in inflight:
                continue
            owner = _tmp_owner_pid(name)
            if owner is not None and owner != os.getpid() and _pid_alive(owner):
                continue
            final = os.path.join(self.dir, name.split(".tmp.")[0])
            if not os.path.exists(final) and self._tmp_complete(path):
                # roll forward: the write finished and verifies, so commit
                # the rename the crash pre-empted — and publish it, if it
                # is newer than whatever LATEST currently names
                os.rename(path, final)
                step = int(os.path.basename(final).split("_")[1])
                latest = self.latest_step()
                if latest is None or step > latest:
                    self._update_latest(step)
            else:
                shutil.rmtree(path, ignore_errors=True)

    def _tmp_complete(self, path: str) -> bool:
        """A tmp dir is salvageable iff its manifest parses and every
        listed leaf verifies against its checksum."""
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            for spec in manifest["leaves"]:
                with open(os.path.join(path, spec["file"]), "rb") as f:
                    blob = f.read()
                if "crc32" in spec and zlib.crc32(blob) != spec["crc32"]:
                    return False
        except (OSError, ValueError, KeyError, TypeError):
            return False
        return True

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return (self.all_steps() or [None])[-1]
        with open(path) as f:
            try:
                step = int(f.read().strip())
            except ValueError:
                step = None  # torn LATEST — fall back to the dirs on disk
        return step if step in self.all_steps() else (self.all_steps() or [None])[-1]

    def _candidate_steps(self, step: int | None) -> list[int]:
        """Restore order: an explicit step is tried alone (strict); with
        ``step=None`` the LATEST designee goes first, then every other
        existing step newest→oldest — the fallback chain."""
        if step is not None:
            return [step]
        latest = self.latest_step()
        if latest is None:
            return []
        rest = [s for s in reversed(self.all_steps()) if s != latest]
        return [latest, *rest]

    def _load_manifest(self, step: int):
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        if not os.path.exists(path):
            if not os.path.isdir(os.path.dirname(path)):
                raise FileNotFoundError(path)  # whole step gone (raced GC)
            raise CorruptSnapshot(step, "manifest.json", "manifest missing")
        try:
            with open(path) as f:
                return json.load(f)
        except ValueError as e:  # JSONDecodeError ⊂ ValueError
            raise CorruptSnapshot(
                step, "manifest.json", f"unparseable manifest: {e}"
            ) from e

    def read_meta(self, step: int | None = None):
        """(meta, step) from the manifest alone — no array loads.

        Lets callers dispatch on snapshot metadata cheaply (e.g. the
        store layer routing a snapshot to its placement class before
        touching the index arrays).  A truncated or garbled manifest
        raises :class:`CorruptSnapshot` naming the step and file, so
        fallback layers can catch it and try an older step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        manifest = self._load_manifest(step)
        try:
            return manifest["meta"], step
        except (KeyError, TypeError) as e:
            raise CorruptSnapshot(
                step, "manifest.json", f"manifest missing keys: {e}"
            ) from e

    def _read_leaf(self, step: int, spec: dict) -> np.ndarray:
        """Read + verify one leaf.  Checksums are compared on the raw
        bytes (catching torn files before np.load can crash on them);
        v1 manifests carry no crc32 and skip verification."""
        path = os.path.join(self.dir, f"step_{step:08d}", spec["file"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError as e:
            raise CorruptSnapshot(step, spec["file"], "leaf file missing") from e
        flip_at = faults.fire("snapshot.read.corrupt", file=spec["file"], step=step)
        if flip_at is not None and len(blob):
            i = int(flip_at) % len(blob)
            blob = blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1 :]
        if "crc32" in spec and zlib.crc32(blob) != spec["crc32"]:
            raise CorruptSnapshot(step, spec["file"], "crc32 mismatch")
        try:
            a = np.load(io.BytesIO(blob), allow_pickle=False)
        except ValueError as e:
            raise CorruptSnapshot(step, spec["file"], f"undecodable: {e}") from e
        return _from_bf16_bits(a) if spec.get("dtype") == "bfloat16" else a

    @staticmethod
    def _leaf_paths(step: int, manifest: dict, keys) -> list:
        """The key path of each leaf: the manifest's own, else those of
        the caller's ``keys(meta, leaf count)`` matched to the leaves in
        sorted order."""
        n_leaves = len(manifest["leaves"])
        if "keys" in manifest:
            paths = manifest["keys"]
        elif keys is None:
            raise ValueError(
                f"the manifest of step {step} names no key paths (a snapshot "
                "written by the repro package): pass the expected keys, "
                "restore(..., keys=)"
            )
        else:
            # the reference flattened its dicts in sorted-key order
            paths = sorted([p] if isinstance(p, str) else list(p)
                           for p in keys(manifest["meta"], n_leaves))
        if len(paths) != n_leaves:
            raise ValueError(
                f"step {step}: {len(paths)} key paths for {n_leaves} leaves"
            )
        return paths

    def _restore_step(self, step: int, keys, shardings=None):
        with self._reading_lock:
            self._reading.add(step)
        try:
            manifest = self._load_manifest(step)
            paths = self._leaf_paths(step, manifest, keys)
            leaves = [self._read_leaf(step, spec) for spec in manifest["leaves"]]
            meta = manifest["meta"]
        except (KeyError, TypeError) as e:
            raise CorruptSnapshot(
                step, "manifest.json", f"manifest missing keys: {e}"
            ) from e
        finally:
            with self._reading_lock:
                self._reading.discard(step)
        if shardings is not None:
            leaves = [_placed(leaf, _sharding_at(shardings, path), path)
                      for leaf, path in zip(leaves, paths)]
        return _unflatten(paths, leaves), meta

    def restore(self, step: int | None = None, *, keys=None, shardings=None):
        """Returns (tree, meta): the tree as nested dicts of numpy arrays
        (with ``shardings``, of host tensors checked against them; see the
        module doc).

        ``keys`` names the leaves of a manifest without key paths (one
        the reference wrote): ``keys(meta, n_leaves)`` returns their key
        paths (a str for a top-level key, else a list of keys).  A
        manifest with key paths ignores it.

        An explicit ``step`` is strict — corruption raises.  With
        ``step=None`` corruption (or a step deleted under us) falls
        back to the next-newest snapshot that verifies; only when every
        candidate fails does the last error propagate."""
        candidates = self._candidate_steps(step)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Exception | None = None
        for s in candidates:
            try:
                return self._restore_step(s, keys, shardings)
            except (CorruptSnapshot, FileNotFoundError, OSError) as e:
                last_err = e
                if step is not None:
                    raise
        raise last_err
