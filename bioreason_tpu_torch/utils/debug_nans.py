"""`--debug_nans`: raise `FloatingPointError` at the first operation that
makes a NaN (the port's counterpart of `jax_debug_nans`, which the JAX
CLIs set, bioreason_tpu/cli/common.py:103-110).

`nan_checks()` enters `NanCheckMode`, a `TorchDispatchMode` that reads
every floating output of every aten op (forward and, since autograd
carries the mode into its backward, the backward's ops too) and raises
naming the op, and autograd's anomaly mode, which adds the forward
traceback of a backward op to the error. The hand kernels launch outside
aten: their wrappers call `check_outputs` on what they wrote. A debugging
flag: every check reads its tensor back to the host, so each op syncs.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

# ops whose outputs are uninitialized memory: NaN there is not made by the op
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                            "new_empty_strided", "resize_", "set_"})


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point() and not t.is_meta
            and t.numel() > 0 and bool(torch.isnan(t).any()))


class NanCheckMode(TorchDispatchMode):
    """Raises FloatingPointError at the first aten op whose floating output
    holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            if any(_has_nan(t) for t in tree_leaves(out)):
                raise FloatingPointError(f"NaN in the output of {func} (--debug_nans)")
        return out


def active() -> bool:
    """Whether a `NanCheckMode` is on this thread's dispatch-mode stack."""
    return any(isinstance(m, NanCheckMode) for m in _get_current_dispatch_mode_stack())


def check_outputs(name: str, *tensors) -> None:
    """Under `nan_checks`, raise FloatingPointError where a hand kernel's
    output holds a NaN (its launch is no aten op the mode sees)."""
    if active() and any(_has_nan(t) for t in tensors):
        raise FloatingPointError(f"NaN in the output of the {name} kernel (--debug_nans)")


@contextlib.contextmanager
def nan_checks(enabled: bool = True):
    """`NanCheckMode` and autograd's anomaly mode while the block runs
    (nothing when `enabled` is false)."""
    if not enabled:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True), NanCheckMode():
        yield
