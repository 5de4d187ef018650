"""Device selection for the public entry points.

``device=None`` means the CUDA card. With no card the entry points raise:
they never fall back to the CPU on their own. The CPU runs the plain
PyTorch versions of the kernels only when a caller asks for it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; sea_codec_torch runs on the GPU by "
            "default -- pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
