"""Where the port's constructors put their tensors.

Every constructor and entry point takes ``device=None``, which means the
current CUDA device: the package is written for the card. With no CUDA
device that raises; nothing moves to the CPU quietly. The CPU path (the
kernels' plain versions, as the tests run them) is asked for by name with
``device="cpu"``. Functions that take tensors follow their tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is the current CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: trajopt_tpu_torch builds its problems on the "
            "GPU unless told otherwise; pass device=\"cpu\" to run the "
            "plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
