"""Serve MoCo embeddings over HTTP (the port's counterpart of
`tools/serve.py`).

    python -m moco_tpu_torch.serve --pretrained runs/encoder.npz \
        --arch resnet50 --port 8080 --telemetry-dir runs/serve/telemetry

Loads the checkpoint's encoder through the checkpoint surgery
(`checkpoint.load_for_inference`, every dialect), captures the bucket
ladder's CUDA graphs (eager on the CPU), optionally loads a kNN bank
(`--knn-bank`, plain or versioned) and its paired ANN index
(`--ann-cells`), and mounts the stdlib front end (`serve/http.py`): POST
/v1/embed, POST /v1/knn, POST /admin/reload (a hot weight swap through the
same loader, or the dual swap with a paired bank), GET /admin/bank,
/healthz, /stats. Every `ServeConfig` field is a `--flag`; `--device cpu`
serves from the CPU (the tests); without it the service runs on the card
and exits 45 where there is none.

SIGTERM/SIGINT drains: in-flight requests complete, new work gets a
structured 503 `draining` (`resilience/preemption.py`; a second signal
exits at once).

Exit codes (`resilience/exitcodes.py`): 0 clean drain, 45 bad config,
checkpoint, bank or device, 47 could not bind host:port.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from moco_tpu_torch.config import ServeConfig, add_config_flags, collect_overrides
from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR, EXIT_OK, EXIT_SERVE_BIND
from moco_tpu_torch.utils.logging import info, log_event


def build_service(config: ServeConfig, device: str = "cuda"):
    """Engine + service from a ServeConfig; returns (service, registry)."""
    from moco_tpu_torch.serve import EmbeddingEngine, EmbedService

    def engine_factory(path: str) -> "EmbeddingEngine":
        # hot reload: POST /admin/reload builds the new engine through the
        # SAME loader and config as the boot-time one, so a reloaded
        # service is indistinguishable from a cold start on that checkpoint
        return EmbeddingEngine.from_checkpoint(
            path, config.arch, image_size=config.image_size,
            cifar_stem=config.cifar_stem, buckets=config.buckets, device=device)

    engine = engine_factory(config.pretrained)
    registry = tracer = None
    if config.telemetry_dir:
        from moco_tpu_torch.telemetry.registry import EVENTS_FILENAME, MetricsRegistry
        from moco_tpu_torch.telemetry.trace import Tracer

        # request/flush/engine spans and SIGUSR1 / trigger-file / shed-spike
        # capture windows land in the same directory; the registry stamps
        # the tracer's run_id so the serve snapshots join the timeline
        tracer = Tracer(config.telemetry_dir, config.trace_mode, proc="serve",
                        capture_steps=config.trace_capture_steps,
                        capture_budget=config.trace_capture_budget)
        registry = MetricsRegistry(os.path.join(config.telemetry_dir, EVENTS_FILENAME),
                                   stamp={"run_id": tracer.run_id,
                                          "trace_id": tracer.trace_id})
    knn_bank = knn_labels = knn_bank_meta = None
    if config.knn_bank:
        from moco_tpu_torch.serve.bankbuild import load_bank

        # a versioned bank comes back with its manifest's metadata (the
        # checkpoint binding and the probe rows) for the dual swap; a plain
        # npz with meta None
        knn_bank, knn_labels, knn_bank_meta = load_bank(config.knn_bank)
    ann_shard = None
    if config.ann_cells:
        # a verified paired index must sit next to the versioned bank; a
        # missing or torn one is a config error (exit 45), never exact kNN
        from moco_tpu_torch.serve import ann as annmod

        loaded = annmod.load_ann(config.knn_bank)  # AnnIndexError -> 45
        if loaded is None:
            raise ValueError(
                f"--ann-cells {config.ann_cells} but bank {config.knn_bank!r} has no ANN "
                "index manifest — build it with python -m moco_tpu_torch.bank_build "
                "--ann-cells")
        arrays, _manifest = loaded
        ann_shard = annmod.AnnShard(
            knn_bank, knn_labels, arrays, shard=config.ann_shard, shards=config.ann_shards,
            nprobe=config.ann_nprobe, rerank=config.ann_rerank or config.knn_k,
            temperature=config.knn_temperature, num_classes=config.num_classes)
    service = EmbedService(
        engine,
        flush_ms=config.flush_ms,
        max_queue=config.max_queue,
        request_deadline_ms=config.request_deadline_ms,
        cache_mb=config.embed_cache_mb,
        registry=registry,
        snapshot_every=config.snapshot_every,
        tracer=tracer,
        shed_spike_min=config.trace_shed_spike,
        knn_bank=knn_bank,
        knn_labels=knn_labels,
        num_classes=config.num_classes,
        knn_k=config.knn_k,
        knn_temperature=config.knn_temperature,
        reload_probe=config.reload_probe,
        reload_min_spread=config.reload_min_spread,
        knn_bank_meta=knn_bank_meta,
        bank_agreement_min=config.bank_agreement_min,
        ann=ann_shard,
        admission_tiers=config.admission_tiers,
        batch_max_queue=config.batch_max_queue,
        batch_deadline_ms=config.batch_deadline_ms,
    )
    service.set_engine_factory(engine_factory)
    return service, registry


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m moco_tpu_torch.serve", description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_config_flags(parser, ServeConfig)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; exits 45 without a card) or cpu")
    args = parser.parse_args(argv)
    from moco_tpu_torch.utils.device import resolve_device, set_precision_policy

    set_precision_policy()
    try:
        config = ServeConfig().replace(**collect_overrides(args, ServeConfig))
        if not config.pretrained:
            raise ValueError("--pretrained <exported encoder> is required")
        device = str(resolve_device(args.device))
    except (ValueError, RuntimeError) as e:
        info(f"config error: {e}")
        return EXIT_CONFIG_ERROR
    try:
        service, registry = build_service(config, device)
    except (ValueError, OSError, KeyError) as e:
        info(f"cannot build the service: {e}")
        return EXIT_CONFIG_ERROR

    from moco_tpu_torch.serve import ServeFrontend

    try:
        frontend = ServeFrontend(service, config.host, config.port)
    except OSError as e:
        info(f"cannot bind {config.host}:{config.port}: {e}")
        return EXIT_SERVE_BIND

    from moco_tpu_torch.resilience.preemption import PreemptionHandler

    if service.tracer is not None:
        service.tracer.install_signal()  # SIGUSR1 arms a capture window
    with PreemptionHandler() as pre:
        frontend.start()
        info(f"serving {config.arch} embeddings on {frontend.url} on {device} "
             f"(buckets {list(config.buckets)}, flush {config.flush_ms} ms, queue "
             f"{config.max_queue}, deadline {config.request_deadline_ms:.0f} ms)")
        while not pre.triggered:
            time.sleep(0.2)
    log_event("serve", "signal received: draining — finishing in-flight batches, "
                       "rejecting new work")
    service.drain(config.drain_timeout_s)
    frontend.shutdown()
    if service.tracer is not None:
        service.tracer.close()
    if registry is not None:
        registry.close()
    info("drained cleanly")
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
