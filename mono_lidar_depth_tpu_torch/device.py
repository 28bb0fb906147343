"""Where the port's tensors live unless the caller says otherwise.

Every `device=` parameter of the port defaults to `default_device()`:
CUDA device 0.  There is no fallback: on a machine without a card the
first allocation raises torch's own error, and a caller that wants the
CPU (the parity tests do) passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[torch.device, str]


def default_device() -> torch.device:
    """CUDA device 0 (constructing the handle touches no CUDA runtime)."""
    return torch.device("cuda", 0)
