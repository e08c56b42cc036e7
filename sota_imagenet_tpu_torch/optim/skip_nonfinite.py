"""``run.skip_nonfinite``: an update with a non-finite gradient is dropped
(port of ``optax.apply_if_finite``, the JAX CLI's wrap, cli.py:241-246;
the reference's AMP GradScaler skip, callbacks.py:308-309).

``ApplyIfFinite`` wraps the port's optimizer (a ZeRO-1 one included). Its
``step`` looks at every gradient the optimizer would read: the step has
already averaged them over the microbatches and the ranks and applied the
gradient transform (AGC) and SAM's second pass, and the weight decay comes
after, inside the inner optimizer. Every rank holds the same averaged
gradient, the whole of it under ZeRO-1 too, so every rank decides alike.
When one of them holds a NaN or an inf the inner optimizer does not step:
the parameters and its state stay as they are. After more than
``max_consecutive_errors`` such steps in a row the update is applied
anyway, so lasting divergence shows. The decision is read on the host,
one device read a step.

It keeps optax's counters, ``notfinite_count``, ``last_finite`` and
``total_notfinite``, and ``update_count``, the updates applied (optax's
inner count): the train step reads the schedule at it for the update, as
the JAX optimizer's schedule reads its own count. All four ride in the
state dict under ``skip``, beside the inner optimizer's under ``inner``.
"""

from __future__ import annotations

from collections import defaultdict

import torch


class ApplyIfFinite(torch.optim.Optimizer):
    """The inner optimizer, stepping only on finite gradients (see the module
    docstring). It shares the inner optimizer's parameter groups, so an lr
    set on them is the inner one's."""

    def __init__(self, inner: torch.optim.Optimizer, max_consecutive_errors: int):
        self.inner, self.max_consecutive_errors = inner, int(max_consecutive_errors)
        super().__init__(inner.param_groups, dict(inner.defaults))
        self.param_groups = inner.param_groups
        self.notfinite_count, self.last_finite, self.total_notfinite, self.update_count = 0, True, 0, 0

    def grads_finite(self) -> bool:
        """Whether every gradient is finite: one fused check per device, one read."""
        by_device = defaultdict(list)
        for g in self.param_groups:
            for p in g["params"]:
                if p.grad is not None:
                    by_device[p.grad.device].append(p.grad)
        flags = []
        for device, grads in by_device.items():
            found = torch.zeros(1, dtype=torch.float32, device=device)
            # multiplies by 1.0, which changes no value
            torch._amp_foreach_non_finite_check_and_unscale_(grads, found, torch.ones(1, device=device))
            flags.append(found)
        return not flags or float(sum(f.cpu() for f in flags)) == 0.0  # the step's one read

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        """The inner step where the gradients are finite or the skips ran out; returns whether it stepped."""
        if closure is not None:
            raise ValueError("ApplyIfFinite.step takes no closure")
        finite = self.grads_finite()
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.last_finite = finite
        self.total_notfinite += 0 if finite else 1
        apply = finite or self.notfinite_count > self.max_consecutive_errors
        if apply:
            self.inner.step()
            self.update_count += 1
        return apply

    def counters(self) -> dict:
        return {"notfinite_count": self.notfinite_count, "last_finite": self.last_finite,
                "total_notfinite": self.total_notfinite, "update_count": self.update_count}

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "skip": self.counters()}

    def load_state_dict(self, state_dict: dict) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        skip = state_dict["skip"]
        self.notfinite_count, self.last_finite = int(skip["notfinite_count"]), bool(skip["last_finite"])
        self.total_notfinite, self.update_count = int(skip["total_notfinite"]), int(skip["update_count"])
        self.param_groups = self.inner.param_groups
