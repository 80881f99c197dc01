"""Build a versioned kNN bank paired to one checkpoint step (the port's
counterpart of `tools/bank_build.py`, with the same flags, files and exit
codes).

    # offline: load the encoder in-process and bulk re-embed
    python -m moco_tpu_torch.bank_build --checkpoint runs/export/7000/encoder.npz \
        --bank-dir runs/bank --corpus runs/corpus.npz \
        --arch resnet_tiny --cifar-stem --image-size 32 \
        --shards 4 --workers 2

    # batch lane: embed through a serving replica ALREADY on the checkpoint
    python -m moco_tpu_torch.bank_build --checkpoint runs/export/7000/encoder.npz \
        --bank-dir runs/bank --corpus runs/corpus.npz \
        --fleet-url http://127.0.0.1:8080

Output (the `serve/bankbuild.py` layout): `<bank-dir>/<step>/bank.npz` +
`<bank-dir>/.integrity/<step>.json`, the manifest binding the bank to the
checkpoint's content hash and recording seeded probe rows: what a
dual-swapping service verifies before rolling (engine, bank) together.
Shard files land atomically under `.build/` and a re-run after a crash
resumes from completed shards; the merge is in dataset-index order, so the
bytes are identical for any --shards value.

The corpus npz needs `images` [N,S,S,3] uint8 + `labels` [N]. --step
defaults to the checkpoint's parent directory name when that is a step
number (the export layout). The offline engine runs on the card unless
`--device cpu`; without a card it exits 45.

With --telemetry-dir, build progress lands as `kind:"bank"` events
(build_start / shard_done / build_done) in events.jsonl.

Train-free: the engine (and torch) is imported only on the offline path;
batch-lane builds load numpy and the standard library alone.

Exit codes: 0 built · 45 bad flags/corpus/checkpoint/device.
"""

from __future__ import annotations

import argparse
import os
import sys

from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR, EXIT_OK
from moco_tpu_torch.utils.logging import info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m moco_tpu_torch.bank_build",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--checkpoint", required=True,
                   help="exported encoder payload the corpus is embedded "
                        "with (the bank binds to its content hash)")
    p.add_argument("--step", type=int, default=-1,
                   help="checkpoint step the bank versions under; -1 "
                        "derives it from the checkpoint's parent dir "
                        "name (the export layout)")
    p.add_argument("--bank-dir", required=True,
                   help="bank root: <bank-dir>/<step>/bank.npz + "
                        ".integrity/<step>.json")
    p.add_argument("--corpus", required=True,
                   help="npz with `images` [N,S,S,3] uint8 + `labels` [N]")
    p.add_argument("--fleet-url", default="",
                   help="batch-lane mode: embed via this service's "
                        "POST /v1/embed (it must already SERVE "
                        "--checkpoint); empty = offline in-process engine")
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--cifar-stem", action="store_true")
    p.add_argument("--buckets", default="1,8,32,128",
                   help="offline engine's padded bucket shapes")
    p.add_argument("--device", default="cuda",
                   help="the offline engine's device: cuda (exits 45 "
                        "without a card) or cpu")
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--probe-rows", type=int, default=8,
                   help="seeded probe rows recorded in the manifest — "
                        "the swap-time space-agreement check")
    p.add_argument("--batch-rows", type=int, default=64,
                   help="rows per embed call inside one shard")
    p.add_argument("--telemetry-dir", default="",
                   help="emit kind:\"bank\" build events here")
    p.add_argument("--ann-cells", type=int, default=0,
                   help="also build the paired IVF ANN index: "
                        "a deterministic k-means coarse quantizer with "
                        "this many cells, written atomically next to "
                        "the bank with its own manifest binding "
                        "index -> bank -> checkpoint; 0 = no index")
    p.add_argument("--ann-kmeans-iters", type=int, default=10,
                   help="Lloyd iterations for the --ann-cells quantizer")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from moco_tpu_torch.serve import bankbuild

    step = args.step
    if step < 0:
        parent = os.path.basename(os.path.dirname(
            os.path.abspath(args.checkpoint)))
        if not parent.isdigit():
            info("config error: --step not given and the checkpoint's "
                 f"parent dir {parent!r} is not a step number")
            return EXIT_CONFIG_ERROR
        step = int(parent)
    if not os.path.isfile(args.checkpoint):
        info(f"config error: no checkpoint at {args.checkpoint!r}")
        return EXIT_CONFIG_ERROR
    try:
        corpus = np.load(args.corpus)
        if "images" not in corpus or "labels" not in corpus:
            raise ValueError(
                f"--corpus {args.corpus!r} needs `images` [N,S,S,3] "
                "uint8 and `labels` [N] arrays"
            )
        images, labels = corpus["images"], corpus["labels"]
    except (OSError, ValueError, KeyError) as e:
        info(f"config error: {e}")
        return EXIT_CONFIG_ERROR

    if args.fleet_url:
        # batch lane: the serving replica does the embedding; this
        # process stays torch-free and a failed request retries the shard
        embed_fn = bankbuild.http_embed_fn(args.fleet_url)
        image_size = int(images.shape[1])
    else:
        try:
            buckets = tuple(
                int(b) for b in str(args.buckets).split(",") if b.strip()
            )
        except ValueError:
            info(f"config error: bad --buckets {args.buckets!r}")
            return EXIT_CONFIG_ERROR
        from moco_tpu_torch.serve import EmbeddingEngine

        try:
            engine = EmbeddingEngine.from_checkpoint(
                args.checkpoint, args.arch, image_size=args.image_size,
                cifar_stem=args.cifar_stem, buckets=buckets,
                device=args.device,
            )
            engine.warmup()
        except (ValueError, OSError, KeyError, RuntimeError) as e:
            info(f"config error: cannot load {args.checkpoint!r}: {e}")
            return EXIT_CONFIG_ERROR

        cap = buckets[-1]

        def embed_fn(batch):
            out = []
            for lo in range(0, len(batch), cap):
                out.append(engine.embed(batch[lo:lo + cap]))
            return np.concatenate(out, axis=0)

        image_size = args.image_size

    registry = None
    emit = None
    if args.telemetry_dir:
        from moco_tpu_torch.telemetry.registry import (
            EVENTS_FILENAME,
            MetricsRegistry,
        )
        from moco_tpu_torch.telemetry.trace import Tracer

        tracer = Tracer(args.telemetry_dir, "off", proc="bank_build")
        registry = MetricsRegistry(
            os.path.join(args.telemetry_dir, EVENTS_FILENAME),
            stamp={"run_id": tracer.run_id, "trace_id": tracer.trace_id},
            flush_every=1,
        )

        def emit(event, **fields):
            registry.emit("bank", event=event, **fields)

    try:
        manifest = bankbuild.build_bank(
            args.bank_dir, step, images, labels, embed_fn,
            checkpoint_path=args.checkpoint, image_size=image_size,
            shards=args.shards, workers=args.workers,
            probe_rows=args.probe_rows, batch_rows=args.batch_rows,
            emit=emit,
        )
    except (bankbuild.BankBuildError, OSError, ValueError) as e:
        info(f"bank build failed: {e}")
        if registry is not None:
            registry.close()
        return EXIT_CONFIG_ERROR
    if args.ann_cells:
        # the index is built AFTER (and bound to) the finished bank: a
        # service seeing a bank manifest without an index manifest knows
        # the build is still in flight and retries, never mispairs
        from moco_tpu_torch.serve import ann as annmod

        try:
            ann_manifest = annmod.build_ann_index(
                args.bank_dir, step, cells=args.ann_cells,
                kmeans_iters=args.ann_kmeans_iters, emit=emit,
            )
        except (annmod.AnnIndexError, OSError, ValueError) as e:
            info(f"ann index build failed: {e}")
            if registry is not None:
                registry.close()
            return EXIT_CONFIG_ERROR
        info(
            f"ann index step {step}: {ann_manifest['cells']} cells over "
            f"{ann_manifest['rows']} rows -> "
            f"{annmod.ann_index_path(args.bank_dir, step)}"
        )
    if registry is not None:
        registry.close()
    info(
        f"bank step {step}: {manifest['rows']} rows x "
        f"{manifest['feat_dim']} dims in {manifest['shards']} shard(s) "
        f"-> {os.path.join(args.bank_dir, str(step), 'bank.npz')} "
        f"(manifest binds checkpoint "
        f"{manifest['checkpoint']['sha256'][:12]}...)"
    )
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
