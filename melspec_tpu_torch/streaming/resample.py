"""Batched streaming resampler for many concurrent streams on one device
(port of ``melspec_tpu.streaming.resample``).

Each stream's source-rate tail is carried as device state and one step
advances every stream, so ingest rate conversion rides the serving tick
(``streaming/serving.py``) instead of a per-client host filter.

- State is ``buf [S, L]``: the last ``L`` source-rate samples, seeded with
  zeros that stand in for the offline op's left zero extension. ``L`` is
  chosen so that (a) every tick consumes exactly the pushed samples
  (``L >= K - down``), (b) the window grid is ``resample_poly``'s (``L ≡
  pad_left (mod down)``), and (c) the spurious leading outputs, windows
  that start before the offline op's first window, total an exact
  multiple of ``align`` (the downstream hop), so a composed frontend's
  frame grid matches a host-resampled stream's after whole hops.
- ``L`` and ``spurious_out`` are the JAX package's, for every ``impl``,
  including the longer tail its kernel routes carry (``auto`` and
  ``kernel``): they fix the frame grid and the warm-up hops, and a port
  that shortened them would move every valid frame. The CUDA kernels need
  no such slack.
- A fresh stream's first ``spurious_out`` outputs are garbage by
  construction; ``SourceRateFrontend`` absorbs them with the mel warm-up
  counter.

Routes (``impl``): ``"kernel"`` and ``"auto"`` run K4 over ``(buf,
chunks)`` where ``kernels.resample.pair_eligible`` takes the tick, else K3
over the concat where ``kernel_eligible`` does; otherwise ``"auto"`` takes
the conv route and ``"kernel"`` raises. On the CPU ``"auto"`` resolves to
the conv route (as the JAX package does off an accelerator) and
``"kernel"`` runs the kernels' plain versions. ``"conv"`` is one strided
``conv1d``; ``"frames"`` is the windows' matmul (the kernels' plain
version). ``precision="bf3"`` applies to the kernels and ``"frames"``;
the conv route computes in full float32 for both precisions (cuDNN has no
bf16x3 mode; float32 is the more accurate).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from melspec_tpu_torch._device import (full_f32, resolve_device,
                                       stream_mask, to_host)
from melspec_tpu_torch.kernels import resample as kres
from melspec_tpu_torch.ops.resample import (_phase_matrix,
                                            kernel_block_m,
                                            resample_kernel_geometry)

__all__ = ["MultiResampleState", "MultiStreamResampler"]


class MultiResampleState(NamedTuple):
    buf: torch.Tensor  # [S, L] carried source-rate tail


class MultiStreamResampler:
    """Rational ``up/down`` resampling of ``S`` concurrent streams as one
    device step.

    - ``init()`` -> fresh state (all streams at their zero left pad)
    - ``step(state, chunks [S, n], active [S])`` -> ``(state, y [S,
      n*up//down])``; ``n`` must be a multiple of the reduced ``down``;
      inactive streams keep their state and their outputs are
      meaningless (mask downstream).
    - ``reset(state, mask [S])`` -> masked streams back to stream start.
    """

    def __init__(self, up: int, down: int, n_streams: int = 16,
                 align: int = 1, beta: float = 5.0, impl: str = "auto",
                 precision: str = "highest", device=None):
        g = math.gcd(up, down)
        up, down = up // g, down // g
        if up == down:
            raise ValueError("identity ratio: no resampler needed")
        if align < 1:
            raise ValueError("align must be >= 1")
        if impl not in ("auto", "conv", "frames", "kernel"):
            raise ValueError(
                "impl must be 'auto', 'conv', 'frames' or 'kernel'")
        if precision not in ("highest", "bf3"):
            raise ValueError("precision must be 'highest' or 'bf3'")
        self.device = resolve_device(device)
        self.precision = precision
        self.impl = impl
        self.up, self.down = up, down
        self.n_streams = n_streams
        self.beta = float(beta)
        g_np, r_lo = _phase_matrix(up, down, self.beta)
        self._k = g_np.shape[0]
        pad_left = -r_lo
        # smallest n_spur with L = pad_left + n_spur*down >= K - down and
        # n_spur*up ≡ 0 (mod align)
        step = align // math.gcd(up, align)
        min_spur = max(0, -(-(self._k - down - pad_left) // down))
        if impl in ("auto", "kernel"):
            # the JAX kernel's slab grid reads (nblk-1)*stride samples past
            # the last chunk boundary, so its kernel routes carry that much
            # more tail; kept for the same frame grid
            geom = resample_kernel_geometry(up, down,
                                            kernel_block_m(up, down))
            if geom is not None:
                _, stride, _, nblk, _ = geom
                need = (nblk - 1) * stride
                min_spur = max(min_spur, -(-(need - pad_left) // down))
        n_spur = -(-min_spur // step) * step
        self._len = pad_left + n_spur * down
        self.spurious_out = n_spur * up
        self._g = torch.as_tensor(g_np.T[:, None, :], dtype=torch.float32,
                                  device=self.device)  # conv weight

    def init(self) -> MultiResampleState:
        return MultiResampleState(buf=torch.zeros(
            (self.n_streams, self._len), dtype=torch.float32,
            device=self.device))

    def step(self, state: MultiResampleState, chunks: torch.Tensor,
             active: torch.Tensor):
        """Consume ``chunks [S, n]`` source-rate samples (a tensor on the
        resampler's device), emit ``[S, n*up//down]``."""
        n = chunks.shape[-1]
        # a silent floor would consume but never filter n % down samples
        # and misalign the stream's window grid for its whole lifetime
        if n % self.down:
            raise ValueError(
                f"chunk length {n} must be a multiple of down={self.down}")
        q = n // self.down
        ch32 = chunks.to(torch.float32)
        up, down, beta, prec = self.up, self.down, self.beta, self.precision
        impl = self.impl
        on_card = self.device.type == "cuda"
        if impl == "kernel" or (impl == "auto" and on_card):
            if kres.pair_eligible(self._len, n, up, down, beta, prec):
                y = kres.resample_pair(state.buf, ch32, up, down, q, beta,
                                       prec)
                tail = ch32[:, n - self._len:]
                return MultiResampleState(
                    torch.where(active[:, None], tail, state.buf)), y
            if kres.kernel_eligible(up, down, beta, prec):
                sig = torch.cat([state.buf, ch32], dim=-1)
                y = kres.resample(sig, up, down, q, beta, prec)
                return MultiResampleState(
                    torch.where(active[:, None], sig[:, n:], state.buf)), y
            if impl == "kernel":
                raise ValueError(
                    "impl='kernel': no Pallas geometry for this "
                    "(ratio, chunk, n_streams) — use 'auto' to fall "
                    "back to the conv path")
        sig = torch.cat([state.buf, ch32], dim=-1)
        if impl == "frames":
            g = kres.resample_matrices(up, down, beta, prec, self.device)
            with full_f32():
                y = kres.resample_reference(sig, g, up, down, q, prec)
        else:
            # the last window ends at (q-1)*down + K <= L + n, since the
            # state length guarantees L >= K - down
            needed = (q - 1) * down + self._k
            with full_f32():
                y = torch.nn.functional.conv1d(
                    sig[:, None, :needed], self._g, stride=down)
            y = y.transpose(-1, -2).reshape(sig.shape[0], q * up)
        return MultiResampleState(
            torch.where(active[:, None], sig[:, n:], state.buf)), y

    def push(self, state: MultiResampleState, chunks, active=None
             ) -> Tuple[MultiResampleState, np.ndarray]:
        """Host-facing step: ``chunks [S, n]`` (numpy or tensor) ->
        ``(state, y [S, n*up//down] numpy)``."""
        chunks = torch.as_tensor(chunks, dtype=torch.float32,
                                 device=self.device)
        if chunks.dim() != 2 or chunks.shape[0] != self.n_streams:
            raise ValueError("chunks must be [n_streams, n]")
        if chunks.shape[1] % self.down:
            raise ValueError(
                f"chunk length must be a multiple of down={self.down}")
        if chunks.shape[1] == 0:
            return state, np.zeros((self.n_streams, 0), np.float32)
        state, y = self.step(
            state, chunks, stream_mask(active, self.n_streams, self.device))
        return state, to_host(y)[0]

    def reset(self, state: MultiResampleState, mask) -> MultiResampleState:
        mask = stream_mask(mask, self.n_streams, self.device)
        return MultiResampleState(
            buf=torch.where(mask[:, None], 0.0, state.buf))
