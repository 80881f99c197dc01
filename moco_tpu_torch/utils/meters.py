"""Console metering (port of `moco_tpu/utils/meters.py`): `AverageMeter` and
`ProgressMeter` (the reference's `main_moco.py` meters), `RateMeter`, and
`Throughput`, the imgs/s meter with its rolling window."""

from __future__ import annotations

import time
from collections import deque


class AverageMeter:
    """Running value and average, printed as `name val (avg)`."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """One tab-separated line per display: `prefix[batch/num_batches]`, then
    each meter."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        fmt = "{:" + str(len(str(num_batches))) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)


class RateMeter:
    """Cumulative event count over attempts, printed `name n (rate%)` (the
    decode-failure meter)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0

    def update(self, count: int, total: int):
        self.count, self.total = int(count), int(total)

    @property
    def rate(self) -> float:
        return self.count / self.total if self.total else 0.0

    def __str__(self):
        return f"{self.name} {self.count} ({100.0 * self.rate:.2f}%)"


class Throughput:
    """imgs/s, cumulative and over a rolling window of recent updates.

    The cumulative rate (`imgs_per_sec`) carries the first steps' warm-up
    stall for the whole epoch; the rolling one (`rolling_imgs_per_sec`,
    the last `window` updates) sheds it within `window` steps. `window=0`
    turns the rolling view off (it then reports the cumulative rate)."""

    def __init__(self, num_chips: int, window: int = 0):
        self.num_chips = num_chips
        self.window = max(int(window), 0)
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0
        # (timestamp, images since the previous entry); the reset entry
        # anchors the first interval, then slides out with the stall
        self._recent: deque | None = (
            deque([(self._t0, 0)], maxlen=self.window + 1) if self.window else None)

    def update(self, n_images: int):
        self._images += n_images
        if self._recent is not None:
            self._recent.append((time.perf_counter(), n_images))

    @property
    def imgs_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0

    @property
    def rolling_imgs_per_sec(self) -> float:
        """Rate over the last `window` updates (cumulative when off or
        before two entries exist); entry 0 only anchors time."""
        if self._recent is None or len(self._recent) < 2:
            return self.imgs_per_sec
        dt = self._recent[-1][0] - self._recent[0][0]
        images = sum(n for _, n in list(self._recent)[1:])
        return images / dt if dt > 0 else 0.0

    @property
    def imgs_per_sec_per_chip(self) -> float:
        return self.imgs_per_sec / max(self.num_chips, 1)
