"""Trainer checkpoints: the trainable parameters, the optimizer state and the
step, in one `torch.save` file (the resumable subset of
bioreason_tpu/train/checkpoint.py; frozen weights are not written, since
they come from the seed or the import that built the model).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

FILE = "state.pt"


def save_checkpoint(path: str, trainable: Dict[str, torch.Tensor], opt_state: Dict,
                    step: int, metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write `path`/state.pt (written to a temporary name, then renamed)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save({"trainable": {k: v.detach().cpu() for k, v in trainable.items()},
                "opt_state": {k: ([t.detach().cpu() for t in v] if isinstance(v, list) else v)
                              for k, v in opt_state.items()},
                "step": int(step), "metadata": dict(metadata or {})}, tmp)
    os.replace(tmp, target)
    return target


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote, tensors on the CPU."""
    return torch.load(os.path.join(path, FILE), map_location="cpu", weights_only=True)
