"""Explicit device resolution.

The port never picks a device by itself: a run names its device
(``Parameters.device``, ``--device``), a request for ``'cuda'`` on a
machine without CUDA raises, and nothing moves to the CPU quietly.  The CPU
runs only when it is asked for by name (the CPU tests do so).
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``torch.device`` for ``name`` ('cuda', 'cuda:0', 'cpu', ...);
    raises ``RuntimeError`` when CUDA is requested but not available."""
    dev = torch.device(name)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but CUDA is not available "
                "on this machine; pass device='cpu' (--device cpu) to run "
                "the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        return dev
    if dev.type != 'cpu':
        raise ValueError(f"unsupported device {str(name)!r}: the port runs "
                         "on 'cuda' (the hand-written kernels) or 'cpu'")
    return dev
