"""Data-parallel scale-out on ``torch.distributed`` (port of
``melspec_tpu.parallel.sharding``).

Every audio clip and every stream is independent, so the batch axis and
the stream axis split over the ranks with no collective; the one
collective is the sum of the frontend step's two VAD aggregates over the
group, the fleet-level figures a deployment reports.

**One process per GPU.** JAX runs one controller per host over all of its
devices: its callables take the GLOBAL ``[B, ...]`` array and return it
sharded. PyTorch runs one process per GPU (``torchrun``), so here each
rank's callable takes ITS OWN block of rows or streams and returns its own
block. The global batch is the ranks' blocks concatenated in rank order.
One process with no group is the degenerate case, JAX's mesh of one
device.

- ``Mesh`` / ``make_mesh``: the group, the axis name, this rank and its
  device;
- ``shard_batch``: a per-clip function on the rank's block (no
  collective);
- ``sharded_whisper_mel``: the whisper pipeline on the rank's rows (K1 on
  CUDA at the sig geometries);
- ``sharded_multistream`` / ``sharded_serving``: the carried-state stream
  mel and the whole serving tick over the rank's streams, with
  whole-fleet checkpoints (rank 0 writes one ``.npz`` of every stream,
  readable by an unsharded frontend of either package);
- ``sharded_frontend_step``: whisper mel + NeMo + Kaldi + VAD + u8 on the
  rank's rows, the two VAD aggregates summed over the group.

No parameters cross ranks. Serving state from the JAX package comes over
through ``convert.from_jax_frontend_state`` /
``from_jax_source_rate_state`` (then each rank takes its rows) or through
a whole-fleet checkpoint written by either package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from melspec_tpu_torch._device import as_signal, resolve_device, stream_mask
from melspec_tpu_torch.config import (BatchLogMelConfig, DetectionSettings,
                                      FbankConfig, MelConfig)
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.ops.quant import quantize_tensor
from melspec_tpu_torch.ops.sig_multihead import (WhisperKaldiFused, check_k2,
                                                 pair_heads)
from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline
from melspec_tpu_torch.ops.vad import classify_columns, smooth_mask
from melspec_tpu_torch.streaming.multistream import MultiStreamMel
from melspec_tpu_torch.streaming.serving import (MultiStreamFrontend,
                                                 SourceRateFrontend)
from melspec_tpu_torch.streaming.state_io import (_flatten, _unflatten,
                                                  load_stream_state,
                                                  save_stream_state)
from melspec_tpu_torch.utils import profiling

__all__ = ["Mesh", "frontend_route", "make_mesh", "shard_batch",
           "sharded_frontend_step", "sharded_multistream", "sharded_serving",
           "sharded_whisper_mel"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a batch is split over: ``group`` (a ``torch.distributed``
    process group, or ``None`` for this process alone, which runs no
    collective), the axis name, the group's size, this process's rank in
    it and the device its block lives on."""

    group: object
    axis: str
    size: int
    rank: int
    device: torch.device

    def __post_init__(self):
        if self.group is None and (self.size, self.rank) != (1, 0):
            raise ValueError("a mesh without a group is one process: "
                             "size 1, rank 0")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} out of range for a group "
                             f"of {self.size}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as JAX's ``Mesh.shape``."""
        return {self.axis: self.size}


def make_mesh(group=None, axis: str = "batch", device=None) -> Mesh:
    """The mesh of ``group``; ``None`` means the default group when one is
    initialized, else this process alone. ``device=None`` means
    ``cuda:{global rank % device count}`` (one process per GPU, ranks
    numbered host by host as ``torchrun`` does) and raises without CUDA;
    ``"cpu"`` runs the plain versions."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size, rank, global_rank = 1, 0, 0
    if group is not None:
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        global_rank = dist.get_rank()
        if rank < 0:
            raise ValueError("this process is not a member of the group")
    dev = resolve_device(device)
    if device is None and dev.type == "cuda":
        dev = torch.device("cuda", global_rank % torch.cuda.device_count())
    return Mesh(group, axis, size, rank, dev)


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes: "
                         f"{tuple(mesh.shape)})")


def _on_host(mesh: Mesh) -> bool:
    """Whether the group's collectives take host tensors: gloo's support
    for CUDA tensors depends on how torch was built, so its collectives
    always go through the host; NCCL (or a group that dispatches by
    device) takes the tensors where they are."""
    return dist.get_backend(mesh.group) == "gloo"


def _all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's group (no collective without one)."""
    if mesh.group is None:
        return t
    host = _on_host(mesh)
    buf = t.cpu() if host else t
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device) if host else buf


def _all_gather(mesh: Mesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (equal shapes on every rank), in rank order, on
    the device the group's collectives take."""
    if mesh.group is None:
        return [t]
    buf = (t.cpu() if _on_host(mesh) else t).contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return parts


def _gather_to_root(mesh: Mesh, t: torch.Tensor):
    """Every rank's ``t`` (equal shapes on every rank), in rank order, on
    rank 0 (on the device the group's collectives take); ``None`` on the
    other ranks."""
    if mesh.group is None:
        return [t]
    buf = (t.cpu() if _on_host(mesh) else t).contiguous()
    parts = ([torch.empty_like(buf) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(buf, parts, dst=dist.get_global_rank(mesh.group, 0),
                group=mesh.group)
    return parts


def shard_batch(fn: Callable, mesh: Mesh, axis: str = "batch") -> Callable:
    """``fn([B_local, ...]) -> [B_local, ...]`` on this rank's block,
    placed on ``mesh.device``. Pure data parallelism: no collective."""
    _check_axis(mesh, axis)

    def call(block):
        return fn(torch.as_tensor(block, device=mesh.device))

    return call


def sharded_whisper_mel(
    mesh: Mesh,
    fft_size: int = 400,
    hop_size: int = 160,
    n_mels: int = 80,
    sampling_rate: float = 16000.0,
    dtype=torch.float32,
    axis: str = "batch",
) -> Callable:
    """Whisper log-mel of this rank's rows: ``[B_local, T] -> [B_local,
    n_frames, n_mels]`` (``WhisperMelPipeline.mel_batch``; K1 on CUDA
    wherever its auto route takes the config)."""
    pipe = WhisperMelPipeline(fft_size, hop_size, n_mels, sampling_rate,
                              dtype=dtype, device=mesh.device)
    return shard_batch(pipe.mel_batch, mesh, axis)


def _stream_axis_spec(mesh: Mesh, axis: str, n_streams: int) -> int:
    """The shared check of the stream-parallel entry points; returns the
    rank's stream count (streams are independent: no collective)."""
    _check_axis(mesh, axis)
    if n_streams % mesh.shape[axis] != 0:
        raise ValueError(
            f"n_streams must divide evenly over mesh axis {axis!r}"
        )
    return n_streams // mesh.size


def _chunks_of(chunks, n_local: int, n_streams: int,
               device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(chunks, dtype=torch.float32, device=device)
    if x.shape[0] != n_local:
        raise ValueError(f"chunks hold {x.shape[0]} streams; this rank "
                         f"serves {n_local} of the {n_streams}")
    return x


def sharded_multistream(
    mesh: Mesh,
    config=None,
    n_streams: int = 64,
    axis: str = "batch",
    fft_impl: str = "rdft",
):
    """The carried-state stream mel over this rank's ``n_streams /
    mesh.size`` streams. Returns ``(multi, init_fn, push_fn)``:
    ``push_fn(state, chunks [S_local, hop], active [S_local])`` ->
    ``(state, mels [S_local, n_mels], valid [S_local])``, tensors on
    ``mesh.device``. ``fft_impl="sig"`` runs K1 at offset = hop."""
    config = config or MelConfig()
    n_local = _stream_axis_spec(mesh, axis, n_streams)
    multi = MultiStreamMel(config, n_local, fft_impl=fft_impl,
                           device=mesh.device)
    hop = config.hop_size

    def push_fn(state, chunks, active):
        x = _chunks_of(chunks, n_local, n_streams, mesh.device)
        if tuple(x.shape) != (n_local, hop):
            raise ValueError("chunks must be [n_streams_local, hop_size]")
        state, _, mels, valid = multi._push_many(
            state, x, stream_mask(active, n_local, mesh.device))
        return state, mels[:, 0], valid[:, 0]

    return multi, multi.init, push_fn


class _FleetCheckpoints:
    """Whole-fleet checkpoints for the rank's frontend of
    ``sharded_serving``: ``save_state`` gathers every rank's streams to
    rank 0 over the group, and rank 0 writes one ``.npz`` with the meta
    of an unsharded frontend of the whole fleet (which either package's
    unsharded frontend reads); ``load_state`` reads such a file on every
    rank (a path every rank can read) and takes the rank's rows."""

    def __init__(self, mesh: Mesh, n_streams: int, *args, **kw):
        super().__init__(*args, **kw)
        self.mesh = mesh
        self.fleet_streams = n_streams

    def state_meta(self) -> dict:
        return {**super().state_meta(), "n_streams": self.fleet_streams}

    def save_state(self, path, state) -> None:
        leaves = []
        _flatten(state, leaves)
        parts = [_gather_to_root(self.mesh, leaf) for leaf in leaves]
        error = None
        if self.mesh.rank == 0:
            try:
                full = [torch.cat(p) for p in parts]
                save_stream_state(path, _unflatten(state, iter(full)),
                                  meta=self.state_meta())
            # every rank must learn that the write failed, or the others
            # would go on as if the checkpoint existed
            except Exception as e:  # noqa: BLE001 (re-raised below)
                error = e
        ok = torch.tensor([int(error is None)], dtype=torch.int32,
                          device=self.device)
        if int(_all_reduce_sum(self.mesh, ok)) != self.mesh.size:
            if error is not None:
                raise error
            raise RuntimeError(f"rank 0 could not write the fleet "
                               f"checkpoint {path}")

    def load_state(self, path):
        local = []
        _flatten(self.init(), local)
        like = [t.new_zeros((self.fleet_streams, *t.shape[1:]),
                            device="cpu") for t in local]
        full = load_stream_state(path, like=_unflatten(self.init(),
                                                       iter(like)),
                                 meta=self.state_meta())
        rows = []
        _flatten(full, rows)
        lo = self.mesh.rank * self.n_streams
        mine = [t[lo : lo + self.n_streams].to(self.device) for t in rows]
        return _unflatten(full, iter(mine))


class _ShardedFrontend(_FleetCheckpoints, MultiStreamFrontend):
    pass


class _ShardedSourceRateFrontend(_FleetCheckpoints, SourceRateFrontend):
    pass


def sharded_serving(
    mesh: Mesh,
    config=None,
    n_streams: int = 64,
    settings: Optional[DetectionSettings] = None,
    axis: str = "batch",
    input_rate: Optional[int] = None,
    fft_impl: str = "rdft",
):
    """The whole serving tick (mel + streaming-VAD decisions + per-frame
    u8, ``streaming/serving.py``) over this rank's ``n_streams /
    mesh.size`` streams. Returns ``(front, init_fn, tick_fn)``;
    ``tick_fn(state, chunks [S_local, H, hop], active [S_local])`` ->
    ``(state, q u8, lo, hi, va, valid)``, tensors on ``mesh.device``. With
    ``input_rate`` the tick is a ``SourceRateFrontend``'s: chunks carry
    ``front.hop_src`` source samples a hop, resampled on the device (K4,
    or K3 on a tick shorter than the carried tail). ``fft_impl="sig"``
    runs the mel on K1. ``front.save_state`` / ``load_state`` checkpoint
    the whole fleet (``_FleetCheckpoints``)."""
    config = config or MelConfig()
    settings = settings or DetectionSettings()
    n_local = _stream_axis_spec(mesh, axis, n_streams)
    if input_rate is not None:
        front = _ShardedSourceRateFrontend(
            mesh, n_streams, config, n_local, input_rate=input_rate,
            settings=settings, fft_impl=fft_impl, device=mesh.device)
    else:
        front = _ShardedFrontend(mesh, n_streams, config, n_local,
                                 settings=settings, fft_impl=fft_impl,
                                 device=mesh.device)

    def tick_fn(state, chunks, active):
        x = _chunks_of(chunks, n_local, n_streams, mesh.device)
        return front._tick(state, x, stream_mask(active, n_local,
                                                 mesh.device))

    return front, front.init, tick_fn


@profiling.spanned("setup.route", route="frontend_route")
def frontend_route(mel_config: MelConfig, fbank_config: FbankConfig,
                   device) -> str:
    """The whisper + Kaldi route of ``sharded_frontend_step`` on
    ``device``: ``"fused"`` (one K2 launch, ``WhisperKaldiFused``) where
    the frontends share a frame grid with a sig geometry and, on CUDA,
    K2 takes their heads; else ``"per_frontend"``, as JAX falls back
    where its fused constructor raises. The heads are built on the CPU;
    no kernel runs."""
    try:
        heads = pair_heads(mel_config, fbank_config)
        check_k2(heads, mel_config.hop_size, device)
    except ValueError:
        return "per_frontend"
    return "fused"


def sharded_frontend_step(
    mesh: Optional[Mesh] = None,
    settings: DetectionSettings = DetectionSettings(),
    axis: str = "batch",
    mel_config: MelConfig | None = None,
    nemo_config: BatchLogMelConfig | None = None,
    fbank_config: FbankConfig | None = None,
    device=None,
):
    """The full frontend as one step on this rank's rows. ``mesh=None``
    means ``make_mesh(device=device)``: the default group when one is
    initialized, else this process alone (a given mesh carries its
    device).

    Returns ``call(samples [B_local, T], valid=None) -> dict`` with
    ``mel``, ``nemo``, ``fbank``, ``vad_smoothed``, ``vad_active_columns``,
    ``vad_total_columns``, ``mel_q8`` and ``mel_q8_range`` (``[1, 2]``: lo,
    hi of this rank's mel block), the JAX step's keys, dtypes and shapes
    for the rank's block, as tensors on the mesh's device. The two VAD
    aggregates are summed over the group (one ``all_reduce``; none
    without a group). ``valid`` is a bool row mask (a row counts fully or
    not at all) or per-row valid-SAMPLE counts (a zero-padded tail
    contributes only its real frames to the aggregates).

    Where whisper and Kaldi share a frame grid (the defaults do) and, on
    CUDA, K2 takes their heads (``frontend_route``), their spectral passes
    and the VAD run as one launch of kernel K2 (``WhisperKaldiFused``);
    otherwise each frontend runs on its own. NeMo runs through
    ``BatchLogMel``, on kernel K1 on CUDA.

    Traced (``utils/profiling.py``), a call is the span ``frontend_step``
    and its four stages, which tile it on the device: ``.spectral``
    (whisper and Kaldi with the raw VAD), ``.nemo``, ``.vad`` (smoothing,
    the valid-frame mask, the aggregates and their sum over the group)
    and ``.quant`` (the u8 block and its range)."""
    if mesh is None:
        mesh = make_mesh(axis=axis, device=device)
    elif device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} differs from the mesh's "
                         f"{mesh.device}")
    _check_axis(mesh, axis)
    dev = mesh.device
    mel_config = mel_config or MelConfig()
    nemo_config = nemo_config or BatchLogMelConfig()
    fbank_config = fbank_config or FbankConfig(apply_cmn=True)
    nemo = BatchLogMel(nemo_config, device=dev)
    fused = None
    if frontend_route(mel_config, fbank_config, dev) == "fused":
        fused = WhisperKaldiFused(mel_config, fbank_config, device=dev)
    else:
        whisper = WhisperMelPipeline(
            mel_config.fft_size, mel_config.hop_size, mel_config.n_mels,
            float(mel_config.sampling_rate), device=dev)
        kaldi = Fbank(fbank_config, device=dev)
    fft, hop = mel_config.fft_size, mel_config.hop_size

    def local_step(x: torch.Tensor, n_valid: torch.Tensor) -> dict:
        stage = profiling.stages(x.device)
        with stage("frontend_step.spectral"):
            if fused is not None:
                # one spectral pass for whisper + kaldi, the Sobel VAD
                # fused as the kernel's epilogue
                mel, fbank_feats, raw = fused.compute_with_vad(x, settings)
            else:
                mel = whisper.mel_batch(x)                    # [b, F, n_mels]
                fbank_feats = kaldi._compute(x)              # [b, F'', bins]
                raw = classify_columns(mel.transpose(-1, -2),
                                       settings)              # [b, F-2]
        with stage("frontend_step.nemo"):
            nemo_feats = nemo._compute(x)                    # [b, bins, F']
        with stage("frontend_step.vad"):
            smoothed = smooth_mask(raw, 4)
            # per-FRAME validity from per-row valid-SAMPLE counts: a
            # zero-padded tail row contributes only its real frames
            nf = smoothed.shape[-1]
            vframes = torch.where(n_valid >= fft, (n_valid - fft) // hop + 1,
                                  0)
            vcols = torch.clamp(vframes - 2, 0, nf).to(torch.int32)  # -2
            mask = torch.arange(nf, device=x.device)[None, :] < vcols[:, None]
            counts = torch.stack([
                torch.sum(smoothed & mask, dtype=torch.int32),
                torch.sum(vcols, dtype=torch.int32)])
            active, total = _all_reduce_sum(mesh, counts)
        with stage("frontend_step.quant"):
            # 8-bit quantization of the rank's mel block; a degenerate
            # range (constant mel) maps to 0
            q, lo, hi = quantize_tensor(mel)
            q_range = torch.stack([lo, hi])[None]
        return {
            "mel": mel,
            "nemo": nemo_feats,
            "fbank": fbank_feats,
            "vad_smoothed": smoothed,
            "vad_active_columns": active,
            "vad_total_columns": total,
            "mel_q8": q,
            "mel_q8_range": q_range,
        }

    def call(samples, valid=None) -> dict:
        """``valid``: a bool row mask, or per-row valid-sample counts
        (integers)."""
        with profiling.span("frontend_step", dev):
            return _call(samples, valid)

    def _call(samples, valid) -> dict:
        x = as_signal(samples, dev)
        n = x.shape[-1]
        if valid is None:
            counts = torch.full((x.shape[0],), n, dtype=torch.int32,
                                device=dev)
        else:
            is_device = isinstance(valid, torch.Tensor)
            varr = valid if is_device else np.asarray(valid)
            if varr.dtype in (np.bool_, torch.bool):
                counts = torch.where(torch.as_tensor(varr, device=dev),
                                     n, 0).to(torch.int32)
            else:
                # integer arrays are per-row SAMPLE counts. One holding a
                # 1 and nothing above it is almost certainly a row mask:
                # as counts it would zero every row's frames, so it is
                # refused. All zeros is unambiguous (nothing valid) and
                # passes. Only host arrays are checked: for a tensor the
                # check would cost a blocking fetch.
                if (n > 1 and not is_device and varr.size
                        and varr.max() == 1 and varr.min() >= 0):
                    raise ValueError(
                        "integer `valid` is interpreted as per-row valid-"
                        "sample counts, but this array holds only 0/1 — "
                        "pass a bool array for a row mask, or real sample "
                        "counts")
                counts = torch.as_tensor(varr, device=dev).to(torch.int32)
        return local_step(x, counts)

    return call
