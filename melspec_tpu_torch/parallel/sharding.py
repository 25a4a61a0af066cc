"""The composite frontend step (port of
``melspec_tpu.parallel.sharding.sharded_frontend_step``).

One call computes, for a batch of clips: whisper log-mel, Kaldi fbank,
the raw Sobel VAD and its smoothing, NeMo log-mel, the VAD aggregates
over the valid frames, and the 8-bit quantization of the whole mel block.
Where whisper and Kaldi share a frame grid (the defaults do) and, on
CUDA, K2 takes their heads (``frontend_route``), their spectral passes
and the VAD run as one launch of kernel K2 (``WhisperKaldiFused``);
otherwise each frontend runs on its own
(``WhisperMelPipeline`` + ``Fbank`` + ``classify_columns``). NeMo runs
through ``BatchLogMel``, on kernel K1 on CUDA.

This slice runs on one rank: with no ``torch.distributed`` group, or a
group of one rank, the two VAD aggregates are the local sums, which is
the JAX step on a one-device mesh. Several ranks (the all-reduce of the
aggregates) are ROADMAP.md item 20.
"""

from __future__ import annotations

import numpy as np
import torch

from melspec_tpu_torch._device import as_signal, resolve_device
from melspec_tpu_torch.config import (BatchLogMelConfig, DetectionSettings,
                                      FbankConfig, MelConfig)
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.ops.quant import quantize_tensor
from melspec_tpu_torch.ops.sig_multihead import (WhisperKaldiFused, check_k2,
                                                 pair_heads)
from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline
from melspec_tpu_torch.ops.vad import classify_columns, smooth_mask

__all__ = ["frontend_route", "sharded_frontend_step"]


def _world_size(group) -> int:
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


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
    group=None,
    settings: DetectionSettings = DetectionSettings(),
    mel_config: MelConfig | None = None,
    nemo_config: BatchLogMelConfig | None = None,
    fbank_config: FbankConfig | None = None,
    device=None,
):
    """The full frontend as one step. ``group`` is the
    ``torch.distributed`` process group the batch is split over (the
    counterpart of the JAX mesh); ``None`` means the default group when
    one is initialized, else this process alone.

    Returns ``call(samples [B, T], valid=None) -> dict`` with ``mel``,
    ``nemo``, ``fbank``, ``vad_smoothed``, ``vad_active_columns``,
    ``vad_total_columns``, ``mel_q8`` and ``mel_q8_range`` (``[1, 2]``:
    lo, hi), the JAX step's keys, dtypes and shapes, as tensors on
    ``device`` (``None``: CUDA). ``valid`` is a bool row mask (a row
    counts fully or not at all) or per-row valid-SAMPLE counts (a
    zero-padded tail contributes only its real frames to the
    aggregates)."""
    if _world_size(group) > 1:
        raise NotImplementedError(
            "sharded_frontend_step over more than one rank (the all-reduce "
            "of the VAD aggregates) is not ported yet (ROADMAP.md, open "
            "item 20)")
    dev = resolve_device(device)
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
        if fused is not None:
            # one spectral pass for whisper + kaldi, the Sobel VAD fused
            # as the kernel's epilogue
            mel, fbank_feats, raw = fused.compute_with_vad(x, settings)
        else:
            mel = whisper.mel_batch(x)                        # [b, F, n_mels]
            fbank_feats = kaldi._compute(x)                  # [b, F'', bins]
            raw = classify_columns(mel.transpose(-1, -2), settings)  # [b, F-2]
        nemo_feats = nemo._compute(x)                        # [b, bins, F']
        smoothed = smooth_mask(raw, 4)

        # per-FRAME validity from per-row valid-SAMPLE counts: a
        # zero-padded tail row contributes only its real frames
        nf = smoothed.shape[-1]
        vframes = torch.where(n_valid >= fft, (n_valid - fft) // hop + 1, 0)
        vcols = torch.clamp(vframes - 2, 0, nf).to(torch.int32)  # Sobel -2
        mask = torch.arange(nf, device=x.device)[None, :] < vcols[:, None]
        active = torch.sum(smoothed & mask, dtype=torch.int32)
        total = torch.sum(vcols, dtype=torch.int32)

        # 8-bit quantization of the whole mel block; a degenerate range
        # (constant mel) maps to 0
        q, lo, hi = quantize_tensor(mel)
        return {
            "mel": mel,
            "nemo": nemo_feats,
            "fbank": fbank_feats,
            "vad_smoothed": smoothed,
            "vad_active_columns": active,
            "vad_total_columns": total,
            "mel_q8": q,
            "mel_q8_range": torch.stack([lo, hi])[None],
        }

    def call(samples, valid=None) -> dict:
        """``valid``: a bool row mask, or per-row valid-sample counts
        (integers)."""
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
