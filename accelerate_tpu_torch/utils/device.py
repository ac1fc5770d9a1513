"""Device resolution for the port's entry points.

The port runs on the card: an entry point given no device takes
``"cuda"``, and raises where there is none.  It runs on the CPU only when
the caller asks for ``"cpu"``, as the tests do — never as a silent
fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a :class:`torch.device`, ``"cuda"`` when None.  Raises
    ``RuntimeError`` for a CUDA device on a machine without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' to run on the CPU explicitly"
        )
    return dev
