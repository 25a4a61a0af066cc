"""Device selection for every public entry point of the port, and the
few device-side helpers they share (full-float32 numerics, per-stream
masks, one-transfer fetches).

The rule is explicit placement with no silent fallback: ``device=None``
means CUDA, and a host without CUDA raises instead of computing on the
CPU. Callers that want the CPU (the tests, the plain reference path) ask
for ``"cpu"`` by name.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` / ``"cuda[:n]"`` / a ``torch.device``
    as given. Raises ``RuntimeError`` when CUDA is asked for (explicitly
    or by default) and this process has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "melspec_tpu_torch: CUDA is not available and no device was "
            "requested; pass device='cpu' to run the plain PyTorch path "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def as_signal(samples, device: torch.device) -> torch.Tensor:
    """Numpy array, list or tensor -> contiguous float32 tensor on
    ``device``."""
    return torch.as_tensor(samples, dtype=torch.float32,
                           device=device).contiguous()


@contextlib.contextmanager
def full_f32():
    """float32 matrix products and cuDNN convolutions in full float32
    inside the block, whatever the process-wide flags say: PyTorch lets
    cuDNN convolutions use TF32 by default (about 1e-3 relative error),
    and a caller may have lowered the matmul precision."""
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    cudnn = torch.backends.cudnn
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prec)


def stream_mask(mask, n_streams: int, device: torch.device) -> torch.Tensor:
    """A per-stream flag vector as a ``[n_streams]`` bool tensor on
    ``device``; ``None`` means every stream."""
    if mask is None:
        return torch.ones(n_streams, dtype=torch.bool, device=device)
    return torch.as_tensor(mask, dtype=torch.bool, device=device)


def to_host(*tensors: torch.Tensor) -> tuple:
    """Numpy copies of ``tensors`` through ONE device-to-host transfer:
    each tensor's bytes are packed into one uint8 buffer on its device,
    which is fetched once and split on the host."""
    parts = [t.detach().contiguous().reshape(-1).view(torch.uint8)
             for t in tensors]
    flat = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for t, part in zip(tensors, parts):
        n = part.numel()
        dtype = np.dtype(str(t.dtype).removeprefix("torch."))
        out.append(flat[off : off + n].copy().view(dtype).reshape(t.shape))
        off += n
    return tuple(out)
