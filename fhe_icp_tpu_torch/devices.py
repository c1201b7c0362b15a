"""Where the port's entry points run: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def target(device: torch.device | str, what: str) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and none is available.

    Entry points never carry on quietly on the CPU: the tests pass
    device="cpu" themselves.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return device
