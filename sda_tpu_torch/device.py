"""Device choice for the port (counterpart of ``sda_tpu/ops/jaxcfg.py``).

The rule: an entry point runs on CUDA unless its caller asks for the CPU
(``device="cpu"``); with no GPU present and no explicit CPU request it
raises instead of silently running on the host. There is no x64 switch to
port: torch has native int64.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else is taken
    as asked, and a CUDA request without a GPU raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the host"
        )
    return dev
