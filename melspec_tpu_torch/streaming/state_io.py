"""Checkpoint / resume for serving-fleet device state (port of
``melspec_tpu.streaming.state_io``).

Every fleet state of the port is a nested ``NamedTuple`` of tensors (hop
buffers, warm-up counters, VAD frame history, resampler tails for ``S``
streams). The saved ``.npz`` records the state's structure (as JAX prints
the treedef of the same NamedTuples, so either package reads the other's
files; the port's earlier spelling, the NamedTuple types and field names,
is still read), each leaf's shape and dtype, and a caller-supplied
``meta`` mapping (the frontends pass their config fingerprint).
``load_stream_state`` checks all of them against a template state, so a
16-stream checkpoint does not load into a 256-stream frontend and a
checkpoint of another hop size does not resume on the wrong frame grid::

    save_stream_state(path, state, meta=front.state_meta())
    state = load_stream_state(path, like=front.init(),
                              meta=front.state_meta())
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Mapping, Optional

import numpy as np
import torch

__all__ = ["save_stream_state", "load_stream_state"]

_FORMAT_VERSION = 1
_META_KEY = "__melspec_state_meta__"


def _canon_path(path) -> str:
    """``np.savez`` appends ``.npz`` to an extensionless path while
    ``np.load`` reads the exact path: normalize once."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _canon_meta(meta: Optional[Mapping[str, Any]]) -> dict:
    if meta is None:
        return {}
    # through JSON, so saved-then-loaded values compare equal to fresh ones
    return json.loads(json.dumps(dict(meta), sort_keys=True))


def _flatten(state, leaves: List) -> str:
    """Append ``state``'s tensor leaves to ``leaves`` in field order and
    return its node string, as ``str(jax.tree_util.tree_structure(...))``
    spells a NamedTuple node."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        inner = ", ".join(_flatten(v, leaves) for v in state)
        return f"CustomNode(namedtuple[{type(state).__name__}], [{inner}])"
    if isinstance(state, torch.Tensor):
        leaves.append(state)
        return "*"
    raise TypeError(f"state leaf is not a tensor: {state!r}")


def _named_structure(state) -> str:
    """The structure string the port wrote before it took JAX's spelling:
    the NamedTuple types and field names, ``*`` for a tensor. The loader
    accepts it, so those checkpoints still resume."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        inner = ", ".join(f"{f}={_named_structure(v)}"
                          for f, v in zip(state._fields, state))
        return f"{type(state).__name__}({inner})"
    return "*"


def _unflatten(like, it):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    return next(it)


def save_stream_state(path, state, meta: Optional[Mapping[str, Any]] = None
                      ) -> None:
    """Checkpoint a carried state (nested NamedTuples of tensors) to one
    ``.npz`` file, with ``meta`` (JSON-serializable) stored beside it."""
    leaves: List[torch.Tensor] = []
    structure = f"PyTreeDef({_flatten(state, leaves)})"
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    header = json.dumps({
        "version": _FORMAT_VERSION,
        "treedef": structure,
        "n_leaves": len(leaves),
        "meta": _canon_meta(meta),
    }, sort_keys=True)
    arrays[_META_KEY] = np.frombuffer(header.encode("utf-8"), np.uint8)
    # atomic replace: a periodic re-save to one path must not lose the
    # previous good checkpoint when interrupted mid-write
    path = _canon_path(path)
    tmp = path + ".tmp.npz"  # .npz suffix: savez would append it anyway
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_stream_state(path, like, meta: Optional[Mapping[str, Any]] = None):
    """Load a checkpoint of :func:`save_stream_state` into ``like``'s
    structure (pass the target's ``init()``): structure, every leaf's
    shape and dtype, and ``meta`` (when given) must match. The leaves land
    on the devices of ``like``'s leaves."""
    import zipfile

    like_leaves: List[torch.Tensor] = []
    like_structure = f"PyTreeDef({_flatten(like, like_leaves)})"
    try:
        ctx = np.load(_canon_path(path))
    except (zipfile.BadZipFile, ValueError, EOFError) as e:
        raise ValueError(f"{path}: corrupt or not an .npz checkpoint "
                         f"({e})") from e
    with ctx as z:
        if _META_KEY not in z:
            raise ValueError(f"{path}: not a melspec stream checkpoint")
        try:
            header = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt checkpoint header "
                             f"({e})") from e
        if header.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"{path}: checkpoint version {header.get('version')!r}, "
                f"expected {_FORMAT_VERSION}")
        if header["treedef"] not in (like_structure,
                                     _named_structure(like)):
            raise ValueError(
                f"{path}: state structure mismatch — checkpoint is "
                f"{header['treedef']}, target expects {like_structure}")
        if meta is not None and header["meta"] != _canon_meta(meta):
            raise ValueError(
                f"{path}: config mismatch — checkpoint meta "
                f"{header['meta']} != expected {_canon_meta(meta)}; "
                "resuming across configs would corrupt the frame grid")
        if header.get("n_leaves") != len(like_leaves):
            raise ValueError(
                f"{path}: {header.get('n_leaves')} leaves in the "
                f"checkpoint, target expects {len(like_leaves)}")
        leaves = []
        for i, ref in enumerate(like_leaves):
            if f"leaf_{i}" not in z:
                raise ValueError(f"{path}: truncated checkpoint — "
                                 f"leaf_{i} missing")
            a = z[f"leaf_{i}"]
            want = np.dtype(str(ref.dtype).removeprefix("torch."))
            if a.shape != tuple(ref.shape) or a.dtype != want:
                raise ValueError(
                    f"{path}: leaf {i} is {a.dtype}{list(a.shape)}, "
                    f"target expects {want}{list(ref.shape)}")
            leaves.append(torch.from_numpy(a).to(ref.device))
    return _unflatten(like, iter(leaves))
