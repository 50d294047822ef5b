"""Fault-tolerant checkpointing: path-keyed npz members + an atomic,
self-checksummed manifest (PyTorch port of ``repro.train.checkpoint``).

The on-disk format is the reference's, byte for byte, so each package's
``verify`` and corrupters work on the other's checkpoints:
  * ``<dir>/step_%08d/`` holds ``arrays.npz`` (one member per leaf,
    keyed by the sanitised leaf path) and ``manifest.json``; both are
    written under ``step_%08d.tmp`` and renamed into place, so a killed
    writer never corrupts a completed checkpoint;
  * manifest version 2: ``version``, ``step``, ``extra`` and, per leaf,
    ``path``, ``key``, ``shape``, ``dtype`` and the ``crc32`` of its raw
    bytes, plus ``checksum``, a SHA-256 over the canonical JSON of the
    rest;
  * a bf16 leaf is a 2-byte raw (``<V2``) member with manifest dtype
    ``"bfloat16"``, as numpy writes the reference's ``ml_dtypes``
    arrays; the port writes and reads its bits through an integer view
    and imports no ``ml_dtypes``.  (The reference's own ``verify``
    rejects such a leaf, its own included: numpy reads the member back
    as ``|V2``, not ``bfloat16``.  The port's accepts it.)

A tree is nested dicts, NamedTuples (optimiser states; a None field is
an empty subtree), ``QTensor``s (leaves ``q`` and ``scale``) and
tensors or numpy arrays; a leaf's path joins its keys with ``/``
(``params/<parameter name>``, ``opt_state/m/<parameter name>/q``).

INTEGRITY: ``verify()`` re-derives the manifest's self-checksum and
every leaf's CRC32 and cross-checks the npz against the manifest, so a
truncated ``arrays.npz``, a deleted member or a flipped manifest byte
makes the checkpoint INVALID.  ``latest_valid_step`` walks steps newest
first and returns the first that passes.

A DTensor leaf (a model or optimiser state placed on a mesh) is written
as its full tensor, in the reference's bytes, so a checkpoint written
under one mesh restores meshless or onto any other mesh, and the
reverse: ``restore`` places each leaf as its template leaf (a DTensor
template leaf keeps its placements) or by ``shardings``.

``AsyncCheckpointer.save`` copies the tree to host memory before it
returns (the trainer updates parameters and optimiser slots in place, so
the next step must not change what is being written); only the
serialisation runs on its thread.  A write failure is boxed and raised
at the next ``save()`` / ``wait()``.  ``keep_last`` also reaps
``step_*.tmp`` directories of writers killed mid-save.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import threading
import time
import warnings
import zipfile
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import is_dtensor
from repro_torch.optim import QTensor

log = logging.getLogger("repro_torch.checkpoint")

MANIFEST_VERSION = 2

_BF16 = "bfloat16"
_V2 = np.dtype("V2")


def _sanitize(p: str) -> str:
    return re.sub(r"[^\w./-]", "_", p).replace("/", "__")


def _json_default(o):
    """numpy scalars / arrays in ``extra`` (a streaming pipeline's
    mutation log) serialise as their Python equivalents."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serialisable: {type(o)!r}")


def _manifest_digest(manifest: dict) -> str:
    """SHA-256 over the canonical JSON of everything but the checksum."""
    body = {k: v for k, v in manifest.items() if k != "checksum"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"),
                      default=_json_default)
    return hashlib.sha256(blob.encode()).hexdigest()


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of the raw bytes (read in place, no copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


# -- trees -------------------------------------------------------------------

def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, QTensor):
        return [("q", node.q), ("scale", node.scale)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, v) for f, v in zip(node._fields, node) if v is not None]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten(tree: Any, prefix: str = "") -> list:
    """[(path, leaf)] in tree order; None subtrees hold no leaves."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _rebuild(tmpl: Any, leaf_fn, prefix: str = ""):
    """``tmpl``'s structure with each leaf replaced by ``leaf_fn(path,
    leaf)``."""
    if tmpl is None:
        return None
    path = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(tmpl, dict):
        return {k: _rebuild(v, leaf_fn, path(k)) for k, v in tmpl.items()}
    if isinstance(tmpl, QTensor):
        return QTensor(leaf_fn(path("q"), tmpl.q),
                       leaf_fn(path("scale"), tmpl.scale), tmpl.shape)
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        return type(tmpl)(*(_rebuild(v, leaf_fn, path(f))
                            for f, v in zip(tmpl._fields, tmpl)))
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_rebuild(v, leaf_fn, path(i))
                          for i, v in enumerate(tmpl))
    return leaf_fn(prefix, tmpl)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory (a copy: the caller
    goes on updating the tensor in place); bf16 as ``|V2`` bits."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_V2)
        return t.numpy()
    return np.array(leaf, copy=True)


def snapshot(tree: Any) -> Any:
    """``tree`` copied to host numpy arrays, structure kept."""
    return _rebuild(tree, lambda _, leaf: _host(leaf))


def _dtype_name(arr: np.ndarray) -> str:
    return _BF16 if arr.dtype == _V2 else str(arr.dtype)


def _read_member(zf: zipfile.ZipFile, key: str) -> np.ndarray:
    """npz member ``key`` as a read-only array over its bytes, read in one
    pass (the zip checks its own CRC as it reads), where ``np.load``
    copies it through small chunks."""
    with zf.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            raise ValueError(f"npy format version {version} is not read")
        data = f.read()
    count = int(np.prod(shape, dtype=np.int64))
    if len(data) != count * dtype.itemsize:
        raise ValueError(f"{len(data)} data bytes for {count} {dtype} values")
    arr = np.frombuffer(data, dtype=dtype, count=count)
    return arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)


def _npz_keys(zf: zipfile.ZipFile) -> set:
    return {n[:-len(".npy")] for n in zf.namelist() if n.endswith(".npy")}


def _savez(path: str, arrays: dict):
    """``np.savez``, member for member, except that a bf16 leaf's header
    says ``'<V2'``, as numpy writes the reference's ``ml_dtypes`` arrays
    (a plain numpy V2 dtype would write ``'|V2'``)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if arr.dtype != _V2:
                    np.lib.format.write_array(fid, arr)
                    continue
                header = np.lib.format.header_data_from_array_1_0(arr)
                header["descr"] = "<V2"
                np.lib.format.write_array_header_1_0(fid, header)
                fid.write(np.ascontiguousarray(arr).reshape(-1).view(
                    np.uint8))


# -- save / verify -------------------------------------------------------------

def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None):
    """Synchronous atomic checkpoint of ``tree``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        # a previous writer died mid-save: worth a trace, not an error
        log.warning("checkpoint save: clobbering stale %s", tmp)
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"version": MANIFEST_VERSION, "step": step, "leaves": [],
                "extra": extra or {}}
    arrays = {}
    for path, leaf in flatten(tree):
        key = _sanitize(path)
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        arrays[key] = arr
        manifest["leaves"].append({
            "path": path, "key": key,
            "shape": list(arr.shape),
            "dtype": _dtype_name(arr),
            "crc32": _crc32(arr),
        })
    manifest["checksum"] = _manifest_digest(manifest)
    _savez(os.path.join(tmp, "arrays.npz"), arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, default=_json_default)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def verify(ckpt_dir: str, step: int) -> Tuple[bool, str]:
    """Integrity check of one checkpoint: (ok, reason).

    In order: the manifest parses; its self-checksum matches; the npz
    opens; every manifest leaf is in the npz with the recorded shape and
    dtype; every leaf's CRC32 matches.  Version-1 manifests without
    checksums pass the structural checks only.
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable: {e}"
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        return False, "manifest malformed: no leaves"
    if "checksum" in manifest and \
            manifest["checksum"] != _manifest_digest(manifest):
        return False, "manifest self-checksum mismatch"
    try:
        data = zipfile.ZipFile(os.path.join(d, "arrays.npz"))
        keys = _npz_keys(data)
    except Exception as e:   # a truncated zip raises various error types
        return False, f"arrays.npz unreadable: {e}"
    try:
        for leaf in manifest["leaves"]:
            key = leaf["key"]
            if key not in keys:
                return False, f"leaf missing from arrays.npz: {leaf['path']}"
            try:
                arr = _read_member(data, key)
            except Exception as e:   # per-member truncation / corruption
                return False, f"leaf unreadable: {leaf['path']}: {e}"
            if list(arr.shape) != list(leaf["shape"]):
                return False, (f"leaf shape mismatch: {leaf['path']} "
                               f"{list(arr.shape)} != {leaf['shape']}")
            if _dtype_name(arr) != leaf["dtype"]:
                return False, (f"leaf dtype mismatch: {leaf['path']} "
                               f"{arr.dtype} != {leaf['dtype']}")
            if "crc32" in leaf and _crc32(arr) != leaf["crc32"]:
                return False, f"leaf crc mismatch: {leaf['path']}"
    finally:
        data.close()
    return True, "ok"


class AsyncCheckpointer:
    """Overlap checkpoint serialisation with training.

    ``save`` snapshots the tree to host memory, then writes it on a
    thread.  A write failure is boxed and re-raised at the NEXT
    ``save()`` or ``wait()``.  ``snapshot_s`` and ``write_s`` are the
    last save's host-copy and serialisation seconds.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.snapshot_s = 0.0
        self.write_s = 0.0

    def save(self, ckpt_dir: str, step: int, tree: Any,
             extra: Optional[dict] = None, *, write: bool = True):
        """``write=False``: the snapshot alone (a rank of a mesh that is not
        the writer: gathering its DTensor leaves is collective)."""
        self.wait()
        t0 = time.perf_counter()
        host_tree = snapshot(tree)   # before training mutates the tensors
        self.snapshot_s = time.perf_counter() - t0
        if not write:
            return

        def _write():
            t1 = time.perf_counter()
            try:
                save(ckpt_dir, step, host_tree, extra)
            except BaseException as e:     # boxed; re-raised at next call
                self._error = e
            self.write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err


# -- discovery and garbage collection -----------------------------------------

def _completed_steps(ckpt_dir: str) -> list:
    return sorted(
        int(m.group(1))
        for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name))
        and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest checkpoint step by EXISTENCE only (no integrity check)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _completed_steps(ckpt_dir)
    return max(steps) if steps else None


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
    """Newest checkpoint that passes ``verify()``; each one skipped is
    logged with its reason."""
    if not os.path.isdir(ckpt_dir):
        return None
    for s in sorted(_completed_steps(ckpt_dir), reverse=True):
        ok, reason = verify(ckpt_dir, s)
        if ok:
            return s
        log.warning("checkpoint step %d failed verify (%s); skipping",
                    s, reason)
    return None


def _tensor_like(arr: np.ndarray, tmpl) -> torch.Tensor:
    """``arr`` as a CPU tensor of ``tmpl``'s dtype (bf16 from its bits)."""
    arr = np.require(arr, requirements="C")      # keeps a 0-d array 0-d
    with warnings.catch_warnings():
        # a read-only view of the member's bytes: only ever copied from
        warnings.simplefilter("ignore", UserWarning)
        if arr.dtype == _V2:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        t = torch.from_numpy(arr)
    want = tmpl.dtype if isinstance(tmpl, torch.Tensor) else None
    return t if want is None else t.to(want)


def _distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of the whole ``t`` (every rank read the same
    bytes, so no data moves)."""
    from repro_torch.dist.sharding import shard_of
    return shard_of(t, mesh, placements)


def restore(ckpt_dir: str, step: int, template: Any, *,
            in_place: bool = False, shardings=None, mesh=None) -> tuple:
    """Restore into the structure of ``template``: (tree, extra).

    Each leaf comes back on the template leaf's device, in its dtype.
    ``in_place=True`` copies the values into the template's own tensors
    (every leaf must be a tensor) and returns the template: one leaf at
    a time crosses from disk to the device, so no second copy of the
    state is ever held.

    A DTensor template leaf gets this rank's shard under its own
    placements.  ``shardings(path, template_leaf)`` -> placements (or
    None: a plain tensor) places the leaves of a plain template onto
    ``mesh`` (``train.elastic.restore_on_mesh``; not with ``in_place``).
    """
    if shardings is not None and (mesh is None or in_place):
        raise ValueError("shardings= needs mesh= and a restore that is "
                         "not in place")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    keys = {leaf["path"]: leaf["key"] for leaf in manifest["leaves"]}
    with zipfile.ZipFile(os.path.join(d, "arrays.npz")) as data:

        def load(path, tmpl):
            if path not in keys:
                raise KeyError(f"checkpoint missing leaf {path}")
            arr = _read_member(data, keys[path])
            want = tuple(getattr(tmpl, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"{path}: checkpoint shape {arr.shape} != "
                                 f"template {want}")
            t = _tensor_like(arr, tmpl)
            if is_dtensor(tmpl):
                t = _distribute(t.to(tmpl.device), tmpl.device_mesh,
                                tmpl.placements)
            if in_place:
                with torch.no_grad():
                    tmpl.copy_(t)
                return tmpl
            if is_dtensor(tmpl):
                return t
            dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
            placements = (None if shardings is None
                          else shardings(path, tmpl))
            if placements is not None:
                return _distribute(t.to(dev), mesh, placements)
            # a tensor of its own: ``t`` views the member's read-only bytes
            return t.to(dev, copy=True)

        tree = _rebuild(template, load)
    return (template if in_place else tree), manifest.get("extra", {})


def discard_after(ckpt_dir: str, step: int):
    """Delete every checkpoint (and ``.tmp``) for steps > ``step``: once a
    run resumes at ``step``, newer ones belong to an abandoned timeline
    (a corrupt newest, or the future a rollback rewound past)."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)(\.tmp)?", name)
        if m and int(m.group(1)) > step:
            log.warning("discarding abandoned-timeline checkpoint %s "
                        "(resumed at step %d)", name, step)
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def keep_last(ckpt_dir: str, n: int = 3):
    """Keep the newest ``n`` checkpoints; also reap orphaned
    ``step_*.tmp`` directories not newer than the newest completed one
    (an in-flight async write is always for a newer step)."""
    if not os.path.isdir(ckpt_dir):
        return
    all_steps = sorted(
        int(m.group(1))
        for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name)))
    for s in all_steps[:-n]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    completed = _completed_steps(ckpt_dir)
    newest = completed[-1] if completed else -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.tmp", name)
        if m and int(m.group(1)) <= newest:
            log.warning("checkpoint GC: removing orphaned %s", name)
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
