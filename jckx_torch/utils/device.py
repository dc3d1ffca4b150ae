"""Device selection for the port's entry points.

The reference picks cuda-else-cpu (``utils.py:4-8``); the port never falls
back quietly: an entry point runs on the card unless its caller asks for
the CPU by name, and with no card and no explicit device it raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; an explicit device is taken as given. Raises
    ``RuntimeError`` when CUDA is wanted and ``torch.cuda.is_available()``
    is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
