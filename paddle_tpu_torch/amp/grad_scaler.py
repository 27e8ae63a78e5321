"""Dynamic loss scaling for the eager loop. Counterpart of
``paddle_tpu/amp/grad_scaler.py``.

    scaler = amp.GradScaler(init_loss_scaling=1024)
    with amp.auto_cast():
        loss = model(x, labels=y)
    scaler.scale(loss).backward()
    scaler.step(opt)          # unscale_, skip the update on inf/nan
    scaler.update()           # shrink after bad steps, grow after good

``unscale_`` multiplies each ``param.grad`` of ``optimizer._all_params()``
by ``1 / scale`` and records whether any came out non-finite; ``step``
then skips ``optimizer.step()``. The train step
(``distributed.fleet.train_step``) reads a scaler's configuration and
scales inside the step instead. ``state_dict`` holds the reference's full
field set; ``load_state_dict`` takes that or the short
``{scale, good_steps, bad_steps}`` one.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        inv = 1.0 / self._scale
        found = False
        for p in optimizer._all_params().values():
            if p.grad is not None:
                g = p.grad * inv
                found = found or not bool(torch.isfinite(g).all())
                p.grad = g
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    # the reference's get/set accessors
    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, value):
        self._scale = float(value)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, value):
        self._incr_ratio = float(value)

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, value):
        self._decr_ratio = float(value)

    def get_incr_every_n_steps(self):
        return self._incr_every

    def set_incr_every_n_steps(self, value):
        self._incr_every = int(value)

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every

    def set_decr_every_n_nan_or_inf(self, value):
        self._decr_every = int(value)

    def state_dict(self):
        # found_inf/unscaled make the dict whole between unscale_() and
        # update(); at step boundaries both are False
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic,
                "found_inf": self._found_inf, "unscaled": self._unscaled}

    def load_state_dict(self, state):
        self._scale = float(state.get("scale", self._scale))
        self._incr_ratio = float(state.get("incr_ratio", self._incr_ratio))
        self._decr_ratio = float(state.get("decr_ratio", self._decr_ratio))
        self._incr_every = int(state.get("incr_every_n_steps",
                                         self._incr_every))
        self._decr_every = int(state.get("decr_every_n_nan_or_inf",
                                         self._decr_every))
        self._good_steps = int(state.get("good_steps", self._good_steps))
        self._bad_steps = int(state.get("bad_steps", self._bad_steps))
        self._dynamic = bool(state.get("use_dynamic_loss_scaling",
                                       self._dynamic))
        self._found_inf = bool(state.get("found_inf", False))
        self._unscaled = bool(state.get("unscaled", False))
