"""Device and dtype resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Asking for CUDA
where there is none raises: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means CUDA. Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]
