"""Bucketed embedding engine: one CUDA graph per bucket (port of
`moco_tpu/serve/engine.py`).

The JAX engine pads every batch to a small fixed ladder of bucket shapes
(default 1/8/32/128) and compiles one XLA program per bucket at `warmup()`,
so steady-state load never compiles. The counterpart on the card is one
`torch.cuda.CUDAGraph` per bucket: `warmup()` captures the whole forward
(uint8 -> f32, normalize, the frozen backbone) over a static uint8 input
buffer of the bucket's shape; `embed()` copies the batch into that buffer
(zeros in the padding rows), replays the graph and returns the first `n`
rows. A replay is one launch from the host, where the eager forward of
ResNet-50 is a few hundred. The graphs of one engine share one memory pool
of their own (captured in ascending order, replayed one at a time under the
engine's lock, each output copied out before the lock is released), so two
engines live during a hot reload never share memory. The capture runs on a
private stream with `capture_error_mode="thread_local"`, so a second engine
can be captured in a reload thread while the first one replays on the
micro-batcher's flush thread. A capture that fails raises; the engine never
runs the eager forward on the card instead.

On the CPU (`device="cpu"`, the tests) the forward runs eagerly and
`compiled_programs()` counts the buckets that have run, as the JAX jit
cache counts its programs.

Soundness of padding: the backbone is in eval mode, so BatchNorm uses its
running statistics and every row is computed independently of the others.
Within one bucket the same image embeds to the same bits wherever it sits
in the batch (the same graph, the same kernels). Across buckets cuDNN may
pick another algorithm for another batch size, so the bits may differ in
the last places; `chip_smoke.py` phase 13 measures by how much.

Preprocessing matches the eval path (`data/augment.py`): uint8 images at the
model resolution are scaled to [0, 1] and normalized with the ImageNet mean
and std. Cropping and resizing stay client-side: the service's contract is
"model-resolution RGB in, feature vector out".
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from moco_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from moco_tpu_torch.serve.batcher import bucket_for, validate_buckets
from moco_tpu_torch.utils.device import resolve_device, set_precision_policy

DEFAULT_BUCKETS = (1, 8, 32, 128)


class EmbeddingEngine:
    """Feature extraction over a fixed bucket ladder.

    `model` is a frozen feature-mode backbone (NHWC f32 images in, [n, D]
    features out), on the device the engine runs on. `embed(images_u8)`
    accepts `[n, S, S, 3]` uint8 with any `1 <= n <= buckets[-1]`, pads to
    the smallest fitting bucket, and returns the first `n` feature rows as
    float32 numpy. Call `warmup()` (the service does) before taking traffic
    so every bucket's graph is already captured."""

    def __init__(self, model, *, image_size: int,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        set_precision_policy()
        self.model = model.eval()
        self.image_size = int(image_size)
        self.buckets = validate_buckets(buckets)
        self.device = next(model.parameters()).device
        self.feat_dim: int | None = None
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=self.device)
        self._inv_std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                                     device=self.device).reciprocal()
        # bucket -> (graph, static uint8 input, static output) on the card;
        # the buckets that have run, on the CPU
        self._graphs: dict[int, tuple] = {}
        self._warmed: set[int] = set()
        self._pool = None
        self._stream = None
        self._lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, path: str, arch: str, *, image_size: int = 224,
                        cifar_stem: bool = False,
                        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                        device="cuda") -> "EmbeddingEngine":
        """Load a pretraining export through the checkpoint surgery
        (`checkpoint.load_for_inference`: the same dialect table the
        linear probe and the Detectron2 converter use): an f32 backbone in
        eval mode with its parameters frozen, on `device`."""
        from moco_tpu_torch.checkpoint import load_for_inference

        model = load_for_inference(path, arch, cifar_stem=cifar_stem,
                                   device=resolve_device(device), image_size=image_size)
        return cls(model, image_size=image_size, buckets=buckets)

    def _forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = images_u8.to(torch.float32) / 255.0
        x = (x - self._mean) * self._inv_std
        return self.model(x).float()

    def _capture(self, bucket: int) -> tuple:
        """Capture the forward of one bucket as a CUDA graph (after two
        eager runs on the capture stream, which settle cuDNN's and the
        allocator's choices outside the graph)."""
        s = self.image_size
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        static_in = torch.zeros((bucket, s, s, 3), dtype=torch.uint8, device=self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            for _ in range(2):
                self._forward(static_in)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            static_out = self._forward(static_in)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return graph, static_in, static_out

    # -- lifecycle -----------------------------------------------------------
    @torch.no_grad()
    def warmup(self) -> int:
        """Capture every bucket's graph (on the CPU: run every bucket once)
        so no live request ever pays a capture. Returns the feature dim."""
        s = self.image_size
        with self._lock:
            for b in self.buckets:
                if self.device.type == "cuda":
                    if b not in self._graphs:
                        self._graphs[b] = self._capture(b)
                    out = self._graphs[b][2]
                else:
                    out = self._forward(torch.zeros((b, s, s, 3), dtype=torch.uint8))
                    self._warmed.add(b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.feat_dim = int(out.shape[-1])
        return self.feat_dim

    def compiled_programs(self) -> int:
        """How many bucket programs exist: captured CUDA graphs on the card,
        buckets that have run on the CPU. After `warmup()` this must STAY at
        `len(buckets)` under any load."""
        return len(self._graphs) if self.device.type == "cuda" else len(self._warmed)

    # -- the hot path --------------------------------------------------------
    @torch.no_grad()
    def embed(self, images_u8: np.ndarray) -> np.ndarray:
        images_u8 = np.asarray(images_u8)
        s = self.image_size
        if (images_u8.ndim != 4 or images_u8.shape[1:] != (s, s, 3)
                or images_u8.dtype != np.uint8):
            raise ValueError(
                f"expected [n, {s}, {s}, 3] uint8, got "
                f"{images_u8.shape} {images_u8.dtype}"
            )
        n = images_u8.shape[0]
        bucket = bucket_for(n, self.buckets)  # raises when n > buckets[-1]
        batch = torch.from_numpy(np.require(images_u8, requirements=("C", "W")))
        with self._lock:
            if self.device.type != "cuda":
                self._warmed.add(bucket)
                if n < bucket:
                    batch = torch.cat([batch, batch.new_zeros((bucket - n, s, s, 3))])
                return self._forward(batch)[:n].numpy().astype(np.float32, copy=True)
            if bucket not in self._graphs:
                self._graphs[bucket] = self._capture(bucket)
            graph, static_in, static_out = self._graphs[bucket]
            static_in[:n].copy_(batch)
            if n < bucket:
                static_in[n:].zero_()
            graph.replay()
            return static_out[:n].cpu().numpy()
