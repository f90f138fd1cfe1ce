"""Device resolution: CUDA unless the caller asks for the CPU, never a fallback."""

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).

    Raises when CUDA is asked for, or left as the default, and is absent: a
    run on the card must not carry on on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for (it is the default) but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return dev
