"""The ``--device`` flag every example program takes, in place of the JAX
examples' ``--platform``. There is no compile cache to enable: the
kernels are cached by source digest under ``melspec_tpu_torch/_build/``."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from melspec_tpu_torch._device import resolve_device

# the repository root, where the default inputs (testdata/) live
REPO = Path(__file__).resolve().parents[2]


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the program computes (default: cuda; a "
                    "host without CUDA then exits with an error, it never "
                    "falls back to the CPU)")


def device(args: argparse.Namespace) -> torch.device:
    """The ``--device`` flag through ``resolve_device``; exits non-zero
    with its message where CUDA is asked for (by default) and absent."""
    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        sys.exit(f"{Path(sys.argv[0]).name}: {exc}")
