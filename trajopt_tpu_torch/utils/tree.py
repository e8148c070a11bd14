"""Precision control for the solver entry points.

Counterpart of ``trajopt_tpu/utils/tree.py::precise``. The JAX package traces
its solvers under ``default_matmul_precision('highest')`` because TPU matmuls
default to bf16 passes. On an NVIDIA card the equivalent hazard is TF32:
float32 products rounded to a 10-bit mantissa. Without full-precision
products the f32 quadrotor solve stalls at meter-level final errors, so the
solver entry points turn TF32 off for their whole run.
"""
from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def precise_context():
    """Turn TF32 off for matmuls and cuDNN inside the block, then restore."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def precise(fn):
    """Run ``fn`` with TF32 off (see :func:`precise_context`)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with precise_context():
            return fn(*args, **kwargs)

    return wrapped
