"""Console metering (port of `moco_tpu/utils/meters.py`'s `AverageMeter` and
`ProgressMeter`, the reference's `main_moco.py` meters)."""

from __future__ import annotations


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
