"""Where the port's entry points run.

Every entry point that creates tensors takes ``device=``. ``None`` means
the CUDA device; the CPU is used only when the caller asks for it
(``device="cpu"``, as the CPU tests do). There is no silent CPU fallback:
a machine without a card raises here instead of running slowly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` → ``cuda``, which must
    be present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "keystone_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly"
        )
    return torch.device("cuda")

