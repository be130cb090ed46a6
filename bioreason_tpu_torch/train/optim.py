"""AdamW with warmup-cosine, global-norm clipping and a non-finite guard (the
port of bioreason_tpu/train/optim.py, which chains optax transforms).

`AdamW.step(grads)` applies, in order, with optax 0.2's semantics:
  1. `apply_if_finite`: a step whose gradients hold a NaN or Inf is skipped
     whole: no parameter moves and neither the Adam count nor the schedule
     advances. `notfinite_count` counts consecutive bad steps (reset by a
     finite one), `total_notfinite` all of them; after more than
     `skip_nonfinite_after` consecutive bad steps the update is applied
     anyway. 0 disables the guard.
  2. `clip_by_global_norm`: g * clip / |g| unless |g| < clip.
  3. `adamw`: mu, nu moments, bias-corrected by the step count, update
     mu_hat / (sqrt(nu_hat) + eps) (eps outside the sqrt), plus decoupled
     weight decay on every trainable parameter, times -lr(count).
The schedule is 0 at step 0 when there is a warmup (the linear ramp starts
at 0), so the first step moves no parameter. `lr_scales` multiplies each
parameter's whole update, weight decay included, after the learning rate:
the DNA-only classifier's `optax.chain(adamw, masked(scale(s)))` for the
encoder's leaves (bioreason_tpu/train/classifier.py:68-77), with the
global norm still clipped over every parameter first.

Finiteness is read from the global norm (one host sync per step): any NaN
or Inf makes it non-finite. It also reads non-finite when finite gradients
overflow fp32 in the sum of squares (|g| > ~1e19), which optax would clip.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

from bioreason_tpu_torch.config import OptimConfig


def cosine_warmup_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """lr(step): optax.warmup_cosine_decay_schedule(0 -> lr over
    total_steps * warmup_ratio steps, cosine to 0 at total_steps), or
    optax.cosine_decay_schedule from lr when warmup_ratio <= 0."""
    peak = cfg.learning_rate

    def cosine(count: float, decay_steps: float) -> float:
        count = min(count, decay_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    if cfg.warmup_ratio <= 0.0:
        decay = float(max(cfg.total_steps, 1))
        return lambda step: cosine(float(step), decay)
    warmup = max(1, int(cfg.total_steps * cfg.warmup_ratio))
    decay = float(max(cfg.total_steps, warmup + 1) - warmup)

    def schedule(step: int) -> float:
        if step < warmup:
            return peak * min(max(step, 0), warmup) / warmup
        return cosine(float(step - warmup), decay)
    return schedule


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


class AdamW:
    """The optimizer over a list of fp32 trainable parameters."""

    def __init__(self, params: Sequence[torch.nn.Parameter], cfg: OptimConfig,
                 lr_scales: Optional[Sequence[float]] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.cfg = cfg
        # parameters grouped by the scale of their update (one group of 1.0
        # without `lr_scales`)
        scales = [1.0] * len(self.params) if lr_scales is None else list(lr_scales)
        if len(scales) != len(self.params):
            raise ValueError(f"{len(scales)} lr_scales for {len(self.params)} parameters")
        self._groups = {s: [i for i, x in enumerate(scales) if x == s] for s in set(scales)}
        self.schedule = cosine_warmup_schedule(cfg)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0                 # accepted steps (Adam's and the schedule's)
        self.notfinite_count = 0       # consecutive non-finite steps
        self.total_notfinite = 0
        self.last_finite = True
        self._acc: Optional[List[torch.Tensor]] = None   # running gradient sum
        self._micro = 0                                  # micro-steps in it

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> float:
        """Apply one update from `grads` (None = zero). Returns the global
        norm of the raw gradients."""
        cfg = self.cfg
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        gnorm = global_norm(grads)
        norm = float(gnorm)            # the one host sync of the step
        finite = math.isfinite(norm)
        self.last_finite = finite
        if cfg.skip_nonfinite_after:
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not finite and self.notfinite_count <= cfg.skip_nonfinite_after:
                return norm

        if not norm < cfg.grad_clip:
            grads = torch._foreach_mul(torch._foreach_div(grads, gnorm), cfg.grad_clip)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = cfg.b1, cfg.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, denom)
        if cfg.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=cfg.weight_decay)
        for scale, idx in self._groups.items():
            torch._foreach_add_([self.params[i] for i in idx], [upd[i] for i in idx],
                                alpha=-lr * scale)
        return norm

    @torch.no_grad()
    def accumulate(self, grads: Sequence[Optional[torch.Tensor]], k: int) -> float:
        """One micro-step of optax.MultiSteps: with k <= 1 this is `step`;
        otherwise `grads` join a running sum and every k-th call applies its
        mean through `step`. Returns the global norm of this micro-step's
        raw gradients."""
        if k <= 1:
            return self.step(grads)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = float(global_norm(grads))
        self._acc = grads if self._acc is None else torch._foreach_add(self._acc, grads)
        self._micro += 1
        if self._micro == k:
            self.step(torch._foreach_div(self._acc, float(k)))
            self._acc, self._micro = None, 0
        return norm

    def state_dict(self) -> Dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite, "last_finite": self.last_finite}

    def load_state_dict(self, state: Dict) -> None:
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)
        for key in ("count", "notfinite_count", "total_notfinite", "last_finite"):
            setattr(self, key, state[key])
