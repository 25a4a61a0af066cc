"""Input dispatch over ranks and hosts (port of
``melspec_tpu.parallel.multihost``): every rank loads and chunks only its
own share of the work-list, and no audio crosses ranks.

1. **Static work partition**: ``shard_files_for_host`` assigns the
   work-list (file paths, stream ids) round-robin to the ranks; every
   rank computes the same partition, with no traffic.
2. **Local load + chunk**: ``load_host_shard`` / ``chunk_audio`` turn the
   rank's decoded clips into a fixed-shape ``[B_local, clip_samples]``
   block (a ragged tail zero-pads; ``n_valid`` keeps its real length).
3. **The rank's block**: ``global_batch_from_local`` checks that every
   rank passes the same block shape (a few ints cross ranks) and places
   the block on the rank's device. JAX assembles a global array here;
   with one process per GPU the rank's block IS its share of the global
   batch (ranks in order), so nothing else moves.
4. **The step**: ``sharded_frontend_step`` on the block; the only bytes
   that cross ranks are the two summed VAD aggregates.

One process with no group is the degenerate case of the same path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.io.wav import read_wav_mono
from melspec_tpu_torch.parallel.sharding import (Mesh, _all_gather,
                                                 _check_axis,
                                                 sharded_frontend_step)

__all__ = ["chunk_audio", "global_batch_from_local", "load_host_shard",
           "multihost_frontend", "shard_files_for_host"]

# the largest block rank global_batch_from_local compares across ranks
_MAX_DIMS = 7


def shard_files_for_host(
    paths: Sequence,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> list:
    """Deterministic round-robin partition of a work-list across ranks.

    Every rank calls this with the SAME ``paths`` order and gets a
    disjoint shard; the union over ranks covers the list exactly once and
    shard sizes differ by at most one. Defaults read the default group
    (``dist.get_rank()`` / ``dist.get_world_size()``), or 0 / 1 with no
    group.
    """
    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index
    if pi is None:
        pi = dist.get_rank() if grouped else 0
    pc = process_count
    if pc is None:
        pc = dist.get_world_size() if grouped else 1
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} out of range for count {pc}")
    return list(paths[pi::pc])


def chunk_audio(
    clips: Sequence[np.ndarray],
    clip_samples: int,
    pad_to_batch: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chop a rank's decoded clips into a fixed-shape batch block.

    Each 1-D float32 clip is split into consecutive ``clip_samples``
    segments; a short tail is zero-padded. Returns ``(segments [B_local,
    clip_samples] f32, n_valid [B_local] i32)`` where ``n_valid`` is the
    count of real (non-pad) samples per row. ``pad_to_batch`` appends
    all-zero rows (``n_valid == 0``) so every rank presents the same block
    shape; a rank with no clips gets one all-zero row.
    """
    rows: List[np.ndarray] = []
    valid: List[int] = []
    for clip in clips:
        clip = np.asarray(clip, dtype=np.float32).reshape(-1)
        for start in range(0, len(clip), clip_samples):
            seg = clip[start : start + clip_samples]
            n = len(seg)
            if n < clip_samples:
                seg = np.pad(seg, (0, clip_samples - n))
            rows.append(seg)
            valid.append(n)
    if pad_to_batch is not None:
        if len(rows) > pad_to_batch:
            raise ValueError(
                f"host produced {len(rows)} segments > pad_to_batch={pad_to_batch}"
            )
        while len(rows) < pad_to_batch:
            rows.append(np.zeros(clip_samples, dtype=np.float32))
            valid.append(0)
    if not rows:
        rows = [np.zeros(clip_samples, dtype=np.float32)]
        valid = [0]
    return np.stack(rows), np.asarray(valid, dtype=np.int32)


def load_host_shard(
    paths: Sequence[Union[str, Path]],
    clip_samples: int,
    pad_to_batch: Optional[int] = None,
    expected_rate: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode THIS rank's WAV shard and chunk it (steps 1 + 2).

    ``paths`` must already be the rank's shard (``shard_files_for_host``).
    16-bit PCM and f32-LE mono are read (``io/wav.py``). A wrong-rate wav
    would silently produce features with the wrong filterbank, so
    ``expected_rate`` (when given) is checked per file.
    """
    clips = []
    for p in paths:
        samples, rate = read_wav_mono(p)
        if expected_rate is not None and rate != expected_rate:
            raise ValueError(
                f"{p}: sample rate {rate} != expected {expected_rate}"
            )
        clips.append(samples)
    return chunk_audio(clips, clip_samples, pad_to_batch=pad_to_batch)


def global_batch_from_local(
    mesh: Mesh,
    local,
    axis: str = "batch",
) -> torch.Tensor:
    """This rank's ``[B_local, ...]`` block on ``mesh.device``: its share
    of the global ``[B_local * mesh.size, ...]`` batch, in rank order.

    Every rank must pass the same block shape (use ``pad_to_batch``): the
    ranks' shapes are all-gathered (a few ints; no audio crosses ranks)
    and a mismatch raises ``ValueError`` on every rank.
    """
    _check_axis(mesh, axis)
    block = torch.as_tensor(local, device=mesh.device)
    if mesh.group is not None:
        if block.dim() > _MAX_DIMS:
            raise ValueError(f"blocks of more than {_MAX_DIMS} dimensions "
                             "are not compared across ranks")
        code = torch.full((1 + _MAX_DIMS,), -1, dtype=torch.int64)
        code[0] = block.dim()
        code[1 : 1 + block.dim()] = torch.tensor(block.shape)
        shapes = [tuple(c[1 : 1 + int(c[0])].tolist())
                  for c in _all_gather(mesh, code.to(mesh.device))]
        if len(set(shapes)) > 1:
            raise ValueError(
                f"every rank must pass the same local block shape (use "
                f"pad_to_batch); by rank: {shapes}")
    return block


_STEP_CACHE: OrderedDict = OrderedDict()
_STEP_LOCK = threading.Lock()


def _cached_frontend_step(mesh, settings, axis):
    """One step per (mesh, settings, axis): building it per call would
    rebuild its matrices every batch. True LRU with per-key reuse (a 17th
    key evicts only the coldest entry) and thread-safe (concurrent misses
    build outside the lock; the first store wins)."""
    key = (mesh, settings, axis)
    with _STEP_LOCK:
        step = _STEP_CACHE.get(key)
        if step is not None:
            _STEP_CACHE.move_to_end(key)
            return step
    step = sharded_frontend_step(mesh, settings, axis=axis)
    with _STEP_LOCK:
        winner = _STEP_CACHE.setdefault(key, step)
        _STEP_CACHE.move_to_end(key)
        while len(_STEP_CACHE) > 16:  # bounded: meshes/settings are few
            _STEP_CACHE.popitem(last=False)
        return winner


def multihost_frontend(
    mesh: Mesh,
    paths: Sequence[Union[str, Path]],
    clip_samples: int,
    local_batch: int,
    settings=None,
    axis: str = "batch",
):
    """End to end: shard the files over the mesh's ranks -> load this
    rank's share (16 kHz) -> its block -> the frontend step. Returns
    ``(outputs, n_valid_local)``: the ``sharded_frontend_step`` dict of
    this rank's ``local_batch`` rows (aggregates summed over the group)
    and the rank's per-row valid-sample counts.
    """
    my_paths = shard_files_for_host(paths, mesh.rank, mesh.size)
    local, n_valid = load_host_shard(my_paths, clip_samples,
                                     pad_to_batch=local_batch,
                                     expected_rate=16000)
    block = global_batch_from_local(mesh, local, axis=axis)
    # per-row valid-sample COUNTS (a tensor: the step's host-side 0/1
    # check does not apply): pad rows (0) and zero-padded tail segments
    # contribute only their real frames to the summed VAD aggregates.
    # Their shape [B_local] follows from the block's, checked above
    valid = torch.as_tensor(n_valid, device=mesh.device)
    step = _cached_frontend_step(mesh, settings or DetectionSettings(),
                                 axis)
    return step(block, valid), n_valid
