"""Typed fault-tolerance errors (port of `moco_tpu/resilience/errors.py`).

The type encodes the recovery policy: the Prefetcher retries
`TransientDataError` with backoff, `NonFiniteLossError` (and its
`CollapseError`) asks the driver for a checkpoint rollback, and
`RollbackExhaustedError` and `DataQualityError` are deliberate run-enders
that no layer catches (`main()` turns them into their exit codes)."""

from __future__ import annotations


class TransientDataError(OSError):
    """A dataset or storage read worth retrying (the Prefetcher retries
    OSError with backoff)."""


class NonFiniteLossError(FloatingPointError):
    """A non-finite loss at `step` (completed steps); `pos` is the
    `(epoch, batch_index)` the poisoned batch was consumed at."""

    def __init__(self, step: int, value: float,
                 pos: tuple[int, int] | None = None):
        super().__init__(f"non-finite loss {value!r} at step {step}")
        self.step = int(step)
        self.value = value
        self.pos = pos


class CollapseError(NonFiniteLossError):
    """A CollapseSentinel predicate fired with rollback opted in: the same
    recovery policy as a non-finite loss."""

    def __init__(self, step: int, predicate: str, value: float,
                 pos: tuple[int, int] | None = None):
        FloatingPointError.__init__(
            self,
            f"collapse predicate {predicate!r} fired at step {step} "
            f"(value {value!r}); requesting rollback",
        )
        self.step = int(step)
        self.predicate = predicate
        self.value = value
        self.pos = pos


class RollbackExhaustedError(RuntimeError):
    """More than `max_rollbacks` consecutive rollbacks: something is
    structurally wrong, a human has to look."""


class DataQualityError(RuntimeError):
    """The decode-failure rate crossed `decode_abort_rate`: enough zero
    canvases to poison training, so going on would waste the run."""
