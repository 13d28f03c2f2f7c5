"""Checkpointing with manifest + async writer, PyTorch port of
``repro.checkpoint.checkpoint``.

Layout:  <dir>/step_<N>/
            manifest.json      — structure (field paths), shapes, dtypes
            leaf_<i>.npy       — one file per leaf (copied to the host)
            COMMITTED          — atomic commit marker (written last)

A state is a nest of NamedTuples, tuples, lists and dicts whose leaves are
tensors (on any device) or numpy arrays.  Its structure is recorded as the
leaves' field paths (``bank.fts.tags``) in depth-first order; the JAX
package records a treedef string instead.  Restore reads only COMMITTED
steps, so a partial write from a killed process is invisible; every write
goes to ``step_<N>.tmp`` and is renamed into place.  The async writer moves
serialization off the caller's thread.

Validation is load-bearing (DESIGN.md §14): ``restore_checkpoint`` checks
the stored field paths and every leaf's shape and dtype against the
``like`` structure and raises ``CheckpointError`` on any mismatch or
unreadable file, never restoring garbage silently, and never through a
bare ``assert``.  ``restore_latest`` walks the committed steps newest first
and *skips* any step that fails validation, so a corrupted latest
checkpoint degrades to the previous committed one.  Tensor leaves restore
onto the device of ``like``'s leaf; a ``like`` leaf on the meta device
(shape and dtype only, the port's abstract ``like``) restores to the CPU.
Leaves numpy cannot hold (bfloat16) are written as float32 with their own
dtype in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint failed validation: uncommitted/corrupt files, or a
    structure (field paths / leaf shape / leaf dtype) mismatch with
    ``like``."""


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(field path, leaf)`` of every leaf, depth first.  ``None`` is an
    empty subtree, as in the JAX package (a ``SimState`` without its
    telemetry cursor has no ``tel`` path)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), x) for i, x in enumerate(tree))
    elif isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    else:
        return [(path, tree)]
    out = []
    for name, x in items:
        out.extend(_flatten(x, f"{path}.{name}" if path else name))
    return out


def _unflatten(like, leaves: List[Any]):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if hasattr(like, "_fields"):
        return type(like)(*[_unflatten(x, leaves) for x in like])
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return leaves.pop(0)


def _dtype_name(leaf) -> Optional[str]:
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return None
    return str(dt).removeprefix("torch.")


def _shape(leaf) -> Optional[tuple]:
    shape = getattr(leaf, "shape", None)
    return None if shape is None else tuple(int(s) for s in shape)


def _to_host(leaf):
    """A leaf as numpy, plus its dtype name (tensors keep theirs)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            return t.numpy(), _dtype_name(t)
        except TypeError:                     # bfloat16, fp8: not in numpy
            return t.float().numpy(), _dtype_name(t)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, step: int, state: Any,
                    extra: Optional[dict] = None):
    d = os.path.join(path, f"step_{step}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(state)
    manifest = {"n_leaves": len(flat), "step": step, "extra": extra or {},
                "paths": [p for p, _ in flat], "leaves": []}
    for i, (_, leaf) in enumerate(flat):
        arr, name = _to_host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)


def _step_of(name: str) -> Optional[int]:
    """``step_<N>`` directory name -> N; None for anything else (stale
    ``step_<N>.tmp`` spills, junk names)."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def committed_steps(path: str) -> List[int]:
    """Committed step numbers under ``path``, newest first.  Uncommitted
    and partially-written directories (a mid-write kill leaves a
    ``step_N.tmp`` or a markerless ``step_N``) are invisible."""
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        step = _step_of(name)
        if step is not None and \
                os.path.exists(os.path.join(path, name, "COMMITTED")):
            steps.append(step)
    return sorted(steps, reverse=True)


def latest_step(path: str) -> Optional[int]:
    steps = committed_steps(path)
    return steps[0] if steps else None


def _restore_leaf(arr: np.ndarray, dtype: str, target):
    if isinstance(target, torch.Tensor):
        dev = "cpu" if target.is_meta else target.device
        return torch.from_numpy(arr).to(dtype=getattr(torch, dtype),
                                        device=dev)
    return arr if str(arr.dtype) == dtype else arr.astype(dtype)


def restore_checkpoint(path: str, step: int, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a nest with tensor or numpy
    leaves), onto each ``like`` leaf's device.

    Every stored leaf is validated against ``like``'s field paths, shapes
    and dtypes; any mismatch, missing file or unreadable array raises
    ``CheckpointError`` — never a silent garbage restore."""
    d = os.path.join(path, f"step_{step}")
    if not os.path.exists(os.path.join(d, "COMMITTED")):
        raise CheckpointError(f"uncommitted checkpoint: {d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable manifest under {d}: {e}") from e
    flat = _flatten(like)
    if manifest.get("n_leaves") != len(flat):
        raise CheckpointError(
            f"structure mismatch: checkpoint {d} holds "
            f"{manifest.get('n_leaves')} leaves, `like` has {len(flat)}")
    paths = [p for p, _ in flat]
    if manifest.get("paths") != paths:
        raise CheckpointError(
            f"structure mismatch under {d}:\n  stored: "
            f"{manifest.get('paths')}\n  like:   {paths}")
    leaves_meta = manifest.get("leaves", [])
    if len(leaves_meta) != len(flat):
        raise CheckpointError(
            f"manifest under {d} records {len(leaves_meta)} leaf entries "
            f"for {len(flat)} leaves")
    out = []
    for i, (name, target) in enumerate(flat):
        meta = leaves_meta[i]
        want_shape = tuple(meta["shape"])
        want_dtype = str(meta["dtype"])
        t_shape, t_dtype = _shape(target), _dtype_name(target)
        if t_shape is not None and t_shape != want_shape:
            raise CheckpointError(
                f"leaf {i} ({name}) shape mismatch under {d}: stored "
                f"{want_shape}, `like` expects {t_shape}")
        if t_dtype is not None and t_dtype != want_dtype:
            raise CheckpointError(
                f"leaf {i} ({name}) dtype mismatch under {d}: stored "
                f"{want_dtype}, `like` expects {t_dtype}")
        try:
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
        except (OSError, ValueError, EOFError) as e:
            raise CheckpointError(
                f"leaf_{i}.npy unreadable under {d}: {e}") from e
        if tuple(arr.shape) != want_shape:
            raise CheckpointError(
                f"leaf_{i}.npy under {d} holds shape {tuple(arr.shape)}, "
                f"manifest records {want_shape} (truncated write?)")
        out.append(_restore_leaf(arr, want_dtype, target))
    return _unflatten(like, out), manifest["extra"]


def restore_latest(path: str, like: Any, *, kind: Optional[str] = None
                   ) -> tuple[Any, int, dict]:
    """Restore the newest committed checkpoint that passes validation.

    Walks ``committed_steps`` newest-first and *skips* any step whose
    restore raises ``CheckpointError`` (truncated leaf, corrupt manifest,
    structure mismatch) — a corrupted latest checkpoint falls back to the
    previous committed one.  ``kind`` additionally requires the manifest's
    ``extra["kind"]`` tag to match (a wrong-kind step is an error, not a
    fallback: it means the directory is being shared across state kinds).
    Returns ``(state, step, extra)``; raises ``CheckpointError`` when no
    committed step survives validation."""
    steps = committed_steps(path)
    if not steps:
        raise CheckpointError(f"no committed checkpoint under {path}")
    last_err: Optional[CheckpointError] = None
    for step in steps:
        try:
            state, extra = restore_checkpoint(path, step, like)
        except CheckpointError as e:
            last_err = e
            continue
        if kind is not None and extra.get("kind", kind) != kind:
            raise CheckpointError(
                f"step_{step} under {path} holds kind "
                f"{extra.get('kind')!r}, expected {kind!r}")
        return state, step, extra
    raise CheckpointError(
        f"every committed checkpoint under {path} failed validation; "
        f"last error: {last_err}")


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a side thread (one in flight)."""

    def __init__(self, path: str):
        self.path = path
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        self.wait()
        # copy to the host on the caller's thread (a consistent snapshot,
        # whatever the caller updates in place next), write on the side
        snap = _unflatten(state, [
            x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else np.array(x) for _, x in _flatten(state)])

        def run():
            try:
                save_checkpoint(self.path, step, snap, extra)
            except Exception as e:           # surfaced on next wait()
                self.last_error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


def save_sim_state(path: str, chunk: int, state: Any,
                   extra: Optional[dict] = None):
    """Checkpoint a mid-trace simulator carry (``dram.SimState``) after
    ``chunk`` completed stream segments (DESIGN.md §13): step == segments
    completed, and the manifest is tagged so a resumed run can check it is
    loading the right kind of state."""
    meta = {"kind": "simstate", "chunk": int(chunk)}
    if extra:
        meta.update(extra)
    save_checkpoint(path, int(chunk), state, meta)


def restore_sim_state(path: str, like: Any,
                      step: Optional[int] = None) -> tuple[Any, int]:
    """Restore the newest (or ``step``'s) committed ``SimState``.

    ``like`` supplies the structure and the device — a fresh
    ``dram.sim_init`` with the run's static/lane layout.  Returns ``(state,
    chunk)``; pass ``chunk`` as ``simulate_stream``'s ``start_chunk`` to
    skip the already-simulated segments.  With ``step=None`` a corrupted
    newest step falls back to the previous committed one
    (``restore_latest``), so ``streaming.resume_stream`` survives
    checkpoint corruption by re-simulating from the last intact
    snapshot."""
    if step is not None:
        state, meta = restore_checkpoint(path, step, like)
        if meta.get("kind", "simstate") != "simstate":
            raise CheckpointError(
                f"step_{step} under {path} is not a simstate checkpoint: "
                f"{meta}")
        return state, int(meta.get("chunk", step))
    state, step, meta = restore_latest(path, like, kind="simstate")
    return state, int(meta.get("chunk", step))
