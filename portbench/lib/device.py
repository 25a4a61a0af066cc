"""Waiting for the device: a no-op on the CPU, where the tests run."""

from __future__ import annotations

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
