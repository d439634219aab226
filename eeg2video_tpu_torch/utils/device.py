"""The one place that turns a device name into a ``torch.device``.

Every entry point of the port takes ``device="cuda"`` by default and passes
it through here: asking for the card where there is none raises, and the CPU
is used only when the caller names it."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
