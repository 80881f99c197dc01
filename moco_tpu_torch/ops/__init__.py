"""Tensor ops of the port: losses, queue, EMA, schedules, resize, and the
CUDA kernels (BN reductions in `stats`, the per-sample blur in `blur`)."""
