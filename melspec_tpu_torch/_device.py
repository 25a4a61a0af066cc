"""Device selection for every public entry point of the port.

The rule is explicit placement with no silent fallback: ``device=None``
means CUDA, and a host without CUDA raises instead of computing on the
CPU. Callers that want the CPU (the tests, the plain reference path) ask
for ``"cpu"`` by name.
"""

from __future__ import annotations

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
