"""Every-step learning sentinels (port of `moco_tpu/resilience/sentinel.py`):
the non-finite loss check and the windowed collapse predicates.

`NaNSentinel` checks EVERY step's loss with a one-step lag: step k's loss is
held, and checked after step k+1 has been launched, so the host read of
step k overlaps step k+1 on the card and never stalls the queue. On the
card the held value is an independent copy: a `non_blocking` copy of the
loss into one slot of a 2-slot pinned host buffer, with a CUDA event a
slot, so nothing the next step reuses is read. A non-finite value raises
`NonFiniteLossError(step, value, pos)`, which the driver answers with a
bounded checkpoint rollback (`train.train`).

`CollapseSentinel` evaluates windowed predicates over the learning-health
scalars the step computes (`telemetry/health.py`): an acc1 floor sustained
over W observations, embedding std pinned at ~0, a vanishing logit margin.
The scalars are held as device tensors for one step and pulled to the host
while the next step runs. A fired predicate logs ONE structured `health`
incident per excursion (re-armed after a clean window); `rollback=True`
raises `CollapseError` into the same rollback instead.
"""

from __future__ import annotations

import math
from collections import deque

import torch

from moco_tpu_torch.resilience.errors import CollapseError, NonFiniteLossError
from moco_tpu_torch.utils.logging import log_event


class NaNSentinel:
    """Hold each step's loss for one step, then check that it is finite.

    `observe(step, loss, pos)` holds step k's loss and checks step k-1's;
    `flush()` checks the one still held (at an epoch's and the run's end,
    so no step goes unchecked). `loss` is a tensor (on the card or the CPU)
    or a plain float (an injected fault). `checks` counts the checks and
    `blocked` those of a card's loss that found its copy not yet complete
    (the host then waited for the step before it; the step just launched
    keeps the card busy meanwhile).
    """

    def __init__(self) -> None:
        self._pending: tuple | None = None
        self._host: torch.Tensor | None = None  # 2 pinned f32 slots
        self._events: list = []
        self._slot = 0
        self.checks = 0
        self.blocked = 0

    def _hold(self, loss):
        """(event or None, an independent copy of `loss`)."""
        if not isinstance(loss, torch.Tensor):
            return None, float(loss)
        loss = loss.detach()
        if not loss.is_cuda:
            return None, loss.clone()
        if self._host is None:
            self._host = torch.empty(2, dtype=torch.float32, pin_memory=True)
            self._events = [torch.cuda.Event(), torch.cuda.Event()]
        slot, self._slot = self._slot, 1 - self._slot
        # queued behind the step on the stream that computed the loss; the
        # slot was last read when the step before this one was checked
        self._host[slot:slot + 1].copy_(loss.float().reshape(1), non_blocking=True)
        self._events[slot].record()
        return self._events[slot], self._host[slot]

    def observe(self, step: int, loss, pos: tuple[int, int] | None = None) -> None:
        """`pos` is the `(epoch, batch_index)` the step consumed; it rides
        the error, so the rollback skips the poisoned batch itself even
        after earlier skips have drifted the step-to-batch mapping."""
        prev, self._pending = self._pending, (int(step), *self._hold(loss), pos)
        if prev is not None:
            self._check(*prev)

    def flush(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._check(*prev)

    def _check(self, step: int, event, held, pos: tuple[int, int] | None) -> None:
        self.checks += 1
        if event is not None:
            if not event.query():
                self.blocked += 1
                event.synchronize()  # a failed launch raises here, as itself
        value = float(held)
        if not math.isfinite(value):
            log_event("sentinel", f"non-finite loss {value!r} at step {step}; requesting "
                                  "rollback")
            raise NonFiniteLossError(step, value, pos)


class CollapseSentinel:
    """Windowed learning-health predicates over the step's own collapse
    scalars.

    `observe(step, scalars, pos)` takes a dict of DEVICE (or host)
    scalars for the just-dispatched step — the always-on `logit_margin`
    and `acc1` every step, the stride-sampled `h_emb_std_*` only on
    health-stride steps — holds it for one step (the one-step lag:
    the host pull overlaps the next step's device compute), then folds
    the previous step's values into per-predicate rings and evaluates:

      margin    every margin in a FULL window  <= collapse_margin
      emb_std   every sampled embedding std in a FULL window
                <= collapse_emb_std (the smaller of the q/k stds per
                sample — either side collapsing is collapse)
      acc1      every acc1 in a FULL window  < collapse_acc1

    A threshold of 0 disables its predicate. Observations at or before
    `min_step` are DISCARDED, not just muted (init-time acc1 IS chance;
    the margin is still forming — warmup values must never satisfy a
    window that fires right after the grace period ends). Requiring the whole window to violate — not a mean — is
    the hysteresis: one healthy observation inside W re-arms the count,
    so a noisy metric cannot page on a blip. Each predicate fires ONE
    `health` incident per excursion and re-arms only after observing a
    fully clean window; with `rollback=True` the first firing raises
    `CollapseError` into the driver's bounded rollback instead.
    """

    #: predicate name -> (scalar keys consumed, comparison label)
    _EMB_KEYS = ("h_emb_std_q", "h_emb_std_k")

    def __init__(self, window: int, *, acc1_floor: float = 0.0,
                 emb_std_eps: float = 0.0, margin_eps: float = 0.0,
                 min_step: int = 0, rollback: bool = False) -> None:
        self.window = max(int(window), 1)
        self.min_step = int(min_step)
        self.rollback = bool(rollback)
        self._thresholds = {
            "margin": float(margin_eps),
            "emb_std": float(emb_std_eps),
            "acc1": float(acc1_floor),
        }
        self._rings: dict[str, deque] = {
            name: deque(maxlen=self.window)
            for name, eps in self._thresholds.items() if eps > 0
        }
        self._alerting: set[str] = set()
        self.fired: list[dict] = []
        self._pending: tuple | None = None

    @property
    def armed(self) -> bool:
        return bool(self._rings)

    def observe(self, step: int, scalars: dict,
                pos: tuple[int, int] | None = None) -> None:
        prev, self._pending = self._pending, (int(step), dict(scalars), pos)
        if prev is not None:
            self._check(*prev)

    def flush(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._check(*prev)

    def _ingest(self, scalars: dict) -> None:
        values = {}
        if "logit_margin" in scalars and "margin" in self._rings:
            values["margin"] = float(scalars["logit_margin"])
        if "acc1" in scalars and "acc1" in self._rings:
            values["acc1"] = float(scalars["acc1"])
        if "emb_std" in self._rings:
            stds = [float(scalars[k]) for k in self._EMB_KEYS
                    if scalars.get(k) is not None]
            if stds:
                values["emb_std"] = min(stds)
        for name, value in values.items():
            self._rings[name].append(value)

    def _violated(self, name: str) -> float | None:
        """The window's worst (most-healthy) value when the predicate is
        violated by the WHOLE window; None otherwise."""
        ring = self._rings[name]
        if len(ring) < self.window:
            return None
        worst = max(ring)
        eps = self._thresholds[name]
        if (name == "acc1" and worst < eps) or (
                name != "acc1" and worst <= eps):
            return worst
        return None

    def _check(self, step: int, scalars: dict,
               pos: tuple[int, int] | None) -> None:
        if step <= self.min_step:
            # the grace period keeps values OUT of the rings too: a
            # window must never be satisfied by warmup-era observations
            # the very knob exists to suppress (they'd otherwise fire a
            # predicate at min_step + 1)
            return
        self._ingest(scalars)
        for name in self._rings:
            value = self._violated(name)
            if value is None:
                if name in self._alerting:
                    # a fully-clean window re-arms the predicate and
                    # says so: the operator sees the excursion END in
                    # the same stream its start landed in
                    if (len(self._rings[name]) == self.window
                            and self._is_clean(name)):
                        self._alerting.discard(name)
                        # its OWN event name: `health` counts incidents
                        # (obsd's collapse_events objective pages on it —
                        # a recovery under the same name would page the
                        # operator for the excursion ENDING)
                        log_event(
                            "health_recovered",
                            f"collapse predicate {name!r} recovered at "
                            f"step {step}",
                            step=step, predicate=name,
                        )
                continue
            if name in self._alerting:
                continue  # one incident per excursion
            self._alerting.add(name)
            incident = dict(step=step, predicate=name, value=value,
                            threshold=self._thresholds[name],
                            window=self.window)
            self.fired.append(incident)
            log_event(
                "health",
                f"collapse predicate {name!r} fired at step {step}: "
                f"window-worst {value:.6g} vs threshold "
                f"{self._thresholds[name]:.6g} over {self.window} "
                f"observation(s)"
                + ("; requesting rollback" if self.rollback else ""),
                **incident,
            )
            if self.rollback:
                raise CollapseError(step, name, value, pos)

    def _is_clean(self, name: str) -> bool:
        """Every value in the (full) window healthy — the re-arm bar."""
        ring = self._rings[name]
        eps = self._thresholds[name]
        if name == "acc1":
            return all(v >= eps for v in ring)
        return all(v > eps for v in ring)
