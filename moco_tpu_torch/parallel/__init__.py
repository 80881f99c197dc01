"""Data parallelism across processes: the process group, ShuffleBN's
collectives and the gradient mean."""
