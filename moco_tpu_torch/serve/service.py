"""Request-path orchestration: admission → cache → batcher → engine (port
of `moco_tpu/serve/service.py`).

`EmbedService` is the front end's single entry point. One `embed()` call
walks: shape/dtype validation, the content-hash embedding LRU, the
micro-batcher's bounded admission queue, a bucketed device call, and the
telemetry instruments — returning a feature row or raising one of the
structured rejections from serve/batcher.py. `classify()` rides the same
path and finishes with a weighted-kNN vote against a precomputed feature
bank (`ops/knn.knn_predict`, the InstDisc protocol the pretrain monitor
uses), on the engine's device.

Telemetry: latency / batch-occupancy / queue-wait histograms feed
cumulative `kind: "serve"` snapshot records into the SAME events.jsonl
stream training writes (`MetricsRegistry`), emitted every
`snapshot_every` batches and once at drain — `tools/telemetry_report.py`
renders the last snapshot as its `serve:` section.

Hot weight reload: `reload(path)` builds a SECOND engine from
a new checkpoint via the configured factory, warms its whole bucket
ladder off-path (the live engine keeps serving throughout), then swaps
the serving state in one reference assignment. The batcher calls the
engine through `_run_batch`, which reads the serving state exactly once
per coalesced batch — so every micro-batch executes entirely on one
engine and the swap lands BETWEEN batches, never inside one. The
content-hash embedding cache is cleared at swap (its rows are functions
of the old weights); requests in flight during the swap simply ride
whichever engine their batch drew — both answer correctly for their
weights, and nothing is dropped.

Atomic dual swap: under a configured kNN bank, a reload must carry a
VERIFIED paired bank (built by `python -m moco_tpu_torch.bank_build` against
the same checkpoint) or it is refused — the old "never under a bank" guard
generalized to "only without a verified pair". The pair is vetted
before any engine is built (manifest integrity, checkpoint-hash
binding) and after warmup by the space-agreement check (the new engine
re-embeds the bank's recorded seeded probe rows; low cosine ⇒
`BankMismatchError`, the fleet's quarantine signal). The swap itself
publishes (engine, bank) under ONE generation bump: `_run_batch` tags
every feature row with the generation it was embedded under, and
`classify()` votes against the bank REGISTERED FOR THAT GENERATION — a
request whose embed rode the old engine across the swap votes against
the old bank, never across spaces.

Shutdown: `drain()` (SIGTERM in `python -m moco_tpu_torch.serve`) stops
admission, lets every accepted request finish, and flushes the final
snapshot — reject new, complete old, then exit."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from moco_tpu_torch.serve.batcher import MicroBatcher
from moco_tpu_torch.serve.cache import EmbeddingCache
from moco_tpu_torch.telemetry.registry import Histogram
from moco_tpu_torch.utils.logging import log_event

# most-recent observations the stats histograms keep: a server runs for
# weeks — unbounded reservoirs (fine for a bounded training run) would
# grow memory and per-snapshot sort cost forever, and an operator wants
# RECENT percentiles from /stats anyway
STATS_WINDOW = 8192


class ReloadRefusedError(ValueError):
    """A hot reload that can NEVER succeed for this process's
    configuration (kNN bank configured, image_size or bucket-ladder
    change, no factory wired) — distinct from a transient load/warmup
    failure so the fleet's converge loop knows to STOP retrying
    (http.py answers 409 for refusals, 503 for retryable failures)."""


class CollapsedCheckpointError(ReloadRefusedError):
    """The reload drift guard rejected the NEW engine: its
    embeddings of the fixed probe batch are degenerate (every probe maps
    to ~one direction — the serving face of representation collapse) or
    unrelated to the previous engine's. Terminal like every refusal, but
    the CHECKPOINT is at fault, not this process's config — the fleet
    quarantines the step dir so no replica (or later fleet) promotes it."""


class BankMismatchError(ReloadRefusedError):
    """The offered (checkpoint, bank) pair failed verification: manifest
    integrity, checkpoint-hash binding, feature-dim, or the
    space-agreement probe check. Terminal like every refusal, and —
    like a collapsed checkpoint — the ARTIFACTS are at fault, not this
    process's config: the fleet quarantines the pair as a unit and rolls
    back any half-swapped replica to the last-known-good pair."""


class _TaggedRows(np.ndarray):
    """Feature rows stamped with the engine generation that embedded
    them. Slicing/viewing preserves the tag (`__array_finalize__`), so
    the per-request row the batcher peels off a coalesced batch still
    knows which generation produced it — classify() uses that to vote
    against the SAME generation's bank across a dual swap."""

    gen: int = -1

    def __array_finalize__(self, obj):
        if obj is not None:
            self.gen = getattr(obj, "gen", -1)


class _ServingState:
    """The (engine, generation) pair `_run_batch` reads in ONE attribute
    load — a dual swap replaces the whole object, so a micro-batch can
    never see the new engine with the old generation or vice versa."""

    __slots__ = ("engine", "gen")

    def __init__(self, engine, gen: int):
        self.engine = engine
        self.gen = gen


class EmbedService:
    def __init__(
        self,
        engine,
        *,
        flush_ms: float = 10.0,
        max_queue: int = 256,
        request_deadline_ms: float = 2000.0,
        cache_mb: int = 0,
        registry=None,
        snapshot_every: int = 25,
        tracer=None,
        shed_spike_min: int = 8,
        knn_bank: np.ndarray | None = None,
        knn_labels: np.ndarray | None = None,
        num_classes: int = 0,
        knn_k: int = 200,
        knn_temperature: float = 0.07,
        reload_probe: int = 8,
        reload_min_spread: float = 1e-4,
        knn_bank_meta: dict | None = None,
        bank_agreement_min: float = 0.98,
        ann=None,
        admission_tiers: bool = True,
        batch_max_queue: int | None = None,
        batch_deadline_ms: float | None = None,
    ):
        self.engine = engine
        self.feat_dim = engine.warmup()  # every bucket captured before traffic
        self.cache = EmbeddingCache(cache_mb) if cache_mb else None
        self.registry = registry
        self.snapshot_every = max(int(snapshot_every), 1)
        self.draining = False
        self.wedged = False  # chaos wedge_at_request: the front end checks
                             # this and stops answering (fleet drill)
        self._lock = threading.Lock()
        # hot reload: the factory (path -> un-warmed engine) is
        # wired by the serve CLI, which owns the arch/buckets config;
        # reloads serialize on their own lock so the live request path
        # never waits on a checkpoint load
        self._engine_factory = None
        self._reload_lock = threading.Lock()
        self.reloads = 0
        # reload drift guard: rows in the fixed probe batch
        # (0 disables the guard) + the spread floor under which a new
        # engine's probe embeddings count as collapsed
        self.reload_probe = int(reload_probe)
        self.reload_min_spread = float(reload_min_spread)
        self._reload_history: list[dict] = []
        self._engine_gen = 0  # bumped at every swap: an in-flight request
                              # that executed on the OLD engine must not
                              # repopulate the just-cleared cache
        self._gen_lock = threading.Lock()  # makes (gen check -> put) in
                              # embed atomic against (gen += 1 -> clear)
                              # in reload — a bare check-then-put could
                              # be descheduled across the whole swap and
                              # insert a stale row AFTER the clear
        self.requests = 0
        self.served = 0
        self._started = time.monotonic()  # uptime is a duration, not a timestamp
        self._h_latency = Histogram("serve_latency_s", window=STATS_WINDOW)
        self._h_queue_wait = Histogram("serve_queue_wait_s",
                                       window=STATS_WINDOW)
        self._request_deadline_s = float(request_deadline_ms) / 1e3
        # tracing: the batcher stamps request/flush/engine spans
        # and arms shed-spike captures; the service ticks the capture
        # window once per executed batch and surfaces the capture state on
        # /healthz + /stats
        self.tracer = tracer
        # tiered admission: interactive vs batch lanes in the
        # batcher; admission_tiers=False collapses everything onto the
        # interactive lane (tier tags are accepted but ignored)
        self.admission_tiers = bool(admission_tiers)
        self.batcher = MicroBatcher(
            self._run_batch,
            buckets=engine.buckets,
            flush_ms=flush_ms,
            max_queue=max_queue,
            default_deadline_ms=request_deadline_ms,
            on_batch=self._note_batch,
            tracer=tracer,
            shed_spike_min=shed_spike_min,
            batch_max_queue=batch_max_queue,
            batch_deadline_ms=batch_deadline_ms,
        )
        # dual swap: the (engine, generation) pair _run_batch
        # reads atomically, the per-generation bank registry classify()
        # resolves tagged rows against, and the versioned-bank metadata
        # (None for a plain --knn-bank npz or a bank-free service)
        self._serving = _ServingState(engine, 0)
        self._knn_by_gen: dict = {}
        self._bank_meta = knn_bank_meta
        self.bank_agreement_min = float(bank_agreement_min)
        self._bank_swaps = 0
        # kNN vote parameters survive a bank swap (and let a bank-free
        # service ADOPT a bank offered by a later dual-swap reload)
        self._knn_defaults = {
            "num_classes": int(num_classes),
            "k": int(knn_k),
            "temperature": float(knn_temperature),
        }
        self._knn = None
        if knn_bank is not None:
            if knn_labels is None or len(knn_bank) != len(knn_labels):
                raise ValueError("knn_bank needs matching knn_labels")
            self._knn = self._make_knn(knn_bank, knn_labels)
            self._knn_by_gen[0] = self._knn
            # one kNN call before traffic too (same rule as engine.warmup)
            self._knn_predict(np.ones((1, self.feat_dim), np.float32))
        # sharded ANN: an AnnShard replaces the exact vote on
        # classify() and answers candidate probes for the fleet's fan-out
        # merge. ann=None keeps the exact path BIT-identical to before.
        if ann is not None and self._knn is None:
            raise ValueError("ann requires a configured kNN bank")
        self._ann = ann
        self._ann_by_gen: dict = {0: ann} if ann is not None else {}
        self.ann_candidate_calls = 0
        # boot-time recall probe vs exact over this shard's rows — the
        # number obsd's ann_recall_probe objective watches
        self._ann_recall = (round(ann.recall_probe(), 4)
                            if ann is not None else None)
        if self.registry is not None:
            self.registry.emit(
                "serve_start",
                image_size=engine.image_size,
                feat_dim=self.feat_dim,
                buckets=list(engine.buckets),
                flush_ms=flush_ms,
                max_queue=max_queue,
                request_deadline_ms=request_deadline_ms,
                cache_mb=cache_mb,
                knn_bank_size=0 if self._knn is None else len(self._knn["bank"]),
                ann=self._ann is not None,
            )

    def _make_knn(self, bank, labels) -> dict:
        labels = np.asarray(labels, np.int32)
        bank = np.asarray(bank, np.float32)
        d = self._knn_defaults
        # the vote runs where the engine runs (a stub engine: the CPU)
        device = getattr(self.engine, "device", "cpu")
        return {
            "bank": torch.from_numpy(bank).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "num_classes": int(d["num_classes"] or labels.max() + 1),
            "k": d["k"],
            "temperature": d["temperature"],
        }

    # -- the engine indirection (hot reload) ---------------------------------
    def _run_batch(self, images_u8: np.ndarray) -> np.ndarray:
        """The batcher's executor. Reads `self._serving` EXACTLY once per
        coalesced batch (one GIL-atomic attribute load), so a concurrent
        `reload()` swap can only land between micro-batches — every batch
        runs whole on one engine, never half-and-half. Rows come back
        generation-tagged so classify() can vote against the SAME
        generation's bank even when a dual swap landed mid-flight."""
        serving = self._serving
        rows = np.asarray(serving.engine.embed(images_u8))
        tagged = rows.view(_TaggedRows)
        tagged.gen = serving.gen
        return tagged

    # -- request paths -------------------------------------------------------
    def embed(self, image: np.ndarray,
              deadline_s: float | None = None,
              tier: str = "interactive") -> tuple[np.ndarray, bool]:
        """One request: returns `(embedding, cache_hit)` or raises a
        `RejectionError` subclass (overloaded / deadline_exceeded /
        draining) — the caller always gets a decision. `tier` picks the
        admission lane: "batch" work sheds independently of
        interactive traffic."""
        if not self.admission_tiers:
            tier = "interactive"
        image = self._validate(image)
        with self._lock:
            self.requests += 1
            n_requests = self.requests
        self._maybe_chaos(n_requests)
        t0 = time.monotonic()
        key = None
        if self.cache is not None:
            key = EmbeddingCache.key_for(image)
            hit = self.cache.get(key)
            if hit is not None:
                with self._lock:
                    self.served += 1
                self._h_latency.observe(time.monotonic() - t0)
                return hit, True
        gen = self._engine_gen  # which engine this request is paying for
        pending = self.batcher.submit(image, deadline_s, tier=tier)
        # generous slack over the request deadline: the batcher ALWAYS
        # resolves accepted requests, so this only guards a dead flusher
        result = pending.wait(
            timeout=(deadline_s or self._request_deadline_s) + 30.0
        )
        self._h_latency.observe(time.monotonic() - t0)
        if self.cache is not None:
            row_gen = getattr(result, "gen", gen)  # the generation that
            # actually embedded this row (tagged in _run_batch); falls
            # back to the admission-time gen for untagged stub engines
            with self._gen_lock:
                # a reload swapped engines while this request was in
                # flight: its row came from the OLD weights and must not
                # repopulate the just-cleared cache as a forever-stale
                # hit. Under the lock the check and the put are one unit
                # against reload's increment-then-clear.
                if row_gen == self._engine_gen:
                    self.cache.put(key, result)
        with self._lock:
            self.served += 1
        return result, False

    def classify(self, image: np.ndarray,
                 deadline_s: float | None = None,
                 tier: str = "interactive") -> tuple[int, np.ndarray, bool]:
        """kNN-classify against the precomputed feature bank: returns
        `(class_id, embedding, cache_hit)`. With an ANN index configured
        the vote runs over the index's probed cells (this replica's
        shard view); without one the exact `ops/knn` path is untouched —
        bit-identical to the pre-ANN `/v1/knn`."""
        if self._knn is None:
            raise ValueError(
                "no kNN feature bank configured (serve with --knn-bank)"
            )
        embedding, cached = self.embed(image, deadline_s, tier=tier)
        # generation-consistent vote: the row is tagged with
        # the generation that embedded it; vote against THAT generation's
        # bank. A cache hit is always current-generation (the cache is
        # cleared inside the swap's gen bump), and a row whose generation
        # left the registry (two swaps inside one request lifetime) falls
        # back to the current bank — never a silent cross-space vote
        # under a single swap.
        row_gen = getattr(embedding, "gen", None)
        if self._ann is not None:
            ann = self._ann_by_gen.get(row_gen, self._ann) \
                if row_gen is not None else self._ann
            pred, _n = ann.classify(np.asarray(embedding))
            return int(pred), embedding, cached
        knn = self._knn_by_gen.get(row_gen, self._knn) \
            if row_gen is not None else self._knn
        pred = self._knn_predict(embedding[None, :], knn=knn)
        return int(pred[0]), embedding, cached

    def ann_candidates(self, embedding) -> dict:
        """One shard's answer to the fleet router's `/v1/knn` fan-out:
        top candidates among the cells THIS replica owns,
        as plain JSON-able (sim, label) pairs plus the vote parameters —
        the stdlib-only router merges across shards and votes without
        ever importing numpy or serve/ann.py."""
        if self._ann is None:
            raise ValueError(
                "no ANN index configured (serve with --ann-cells and a "
                "bank built via python -m moco_tpu_torch.bank_build --ann-cells)"
            )
        q = np.asarray(embedding, np.float32).reshape(-1)
        if q.shape[0] != self.feat_dim:
            raise ValueError(
                f"embedding dim {q.shape[0]} != feat_dim {self.feat_dim}"
            )
        ann = self._ann
        sims, labels, _rows = ann.search(q)
        with self._lock:
            self.ann_candidate_calls += 1
        return {
            "candidates": [[float(s), int(lab)]
                           for s, lab in zip(sims, labels)],
            "temperature": ann.temperature,
            "k": int(self._knn["k"]) if self._knn is not None
            else ann.rerank,
            "num_classes": ann.num_classes,
            "shard": ann.shard,
            "shards": ann.shards,
        }

    def _knn_predict(self, features: np.ndarray,
                     knn: dict | None = None) -> np.ndarray:
        from moco_tpu_torch.ops.knn import knn_predict

        k = self._knn if knn is None else knn
        feats = torch.from_numpy(np.asarray(features, np.float32)).to(k["bank"].device)
        return knn_predict(
            feats, k["bank"], k["labels"], k["num_classes"],
            k=k["k"], temperature=k["temperature"],
        ).cpu().numpy()

    def _validate(self, image) -> np.ndarray:
        image = np.asarray(image)
        s = self.engine.image_size
        if image.shape != (s, s, 3) or image.dtype != np.uint8:
            raise ValueError(
                f"expected one [{s}, {s}, 3] uint8 image, got "
                f"{image.shape} {image.dtype}"
            )
        return image

    def _maybe_chaos(self, n_requests: int) -> None:
        """Fleet-drill faults: a SIGKILL or an accepting-but-
        not-answering wedge at the configured request count. Imported
        lazily: chaos is a drill facility, not a request-path dependency."""
        from moco_tpu_torch.resilience.chaos import active_chaos

        plan = active_chaos()
        if plan is None:
            return
        plan.maybe_kill_request(n_requests)  # no return: SIGKILL
        if plan.maybe_wedge_request(n_requests):
            self.wedged = True  # the front end hangs every LATER request

    # -- hot weight reload ----------------------------------------
    def set_engine_factory(self, factory) -> None:
        """`factory(checkpoint_path) -> EmbeddingEngine` (un-warmed).
        The serve CLI wires `EmbeddingEngine.from_checkpoint` with its
        arch/buckets config; tests wire in-process builders."""
        self._engine_factory = factory

    def reload(self, pretrained: str, step: int | None = None,
               bank: str | None = None,
               bank_step: int | None = None) -> dict:
        """Build + warm a new engine from `pretrained` OFF the request
        path, then atomically swap it in (see `_run_batch`). Raises
        ValueError on any failure — the old engine keeps serving, nothing
        is dropped. Serialized: concurrent reloads queue on the lock.

        Dual swap: pass `bank` (a versioned bank npz built by
        `python -m moco_tpu_torch.bank_build` against the SAME checkpoint)
        to roll engine
        and kNN bank together under one generation bump. The pair is
        verified before the swap — manifest integrity, checkpoint-hash
        binding, feature-dim, and the post-warmup space-agreement probe —
        and any failure raises `BankMismatchError` with the old pair
        untouched. Under a configured bank, a bank-LESS reload refuses."""
        if self._engine_factory is None:
            raise ReloadRefusedError(
                "hot reload is not configured (no engine factory; serve "
                "with python -m moco_tpu_torch.serve or call set_engine_factory)"
            )
        with self._reload_lock:
            # cheap refusals FIRST: every check that needs no (or only an
            # un-warmed) engine runs before the minutes-scale ladder
            # warmup, so a refused reload — which a fleet's converge loop
            # may re-attempt — never burns a checkpoint load + capture
            if self._knn is not None and bank is None:
                # the feature bank was computed by the OLD encoder; new
                # embeddings live in a different space, so /v1/knn would
                # silently classify across spaces — refuse UNLESS the
                # reload carries a verified paired bank (the dual swap)
                e = ReloadRefusedError(
                    "hot reload is refused under a configured kNN bank "
                    "without a verified paired bank: the bank's features "
                    "were computed by the old encoder and would silently "
                    "mismatch the new embedding space — build a paired "
                    "bank with python -m moco_tpu_torch.bank_build against the new "
                    "checkpoint and reload the (pretrained, bank) pair "
                    "together"
                )
                e.bank_step = None if self._bank_meta is None \
                    else self._bank_meta.get("step")
                raise e
            new_knn = new_meta = new_ann = None
            if bank is not None:
                # the whole pair is vetted BEFORE the factory runs: a
                # doctored or torn bank must cost hashing, not a
                # checkpoint load + ladder capture
                bank_feats, bank_labels, new_meta = \
                    self._verify_bank_pair(bank, pretrained, bank_step)
                new_knn = self._make_knn(bank_feats, bank_labels)
                if self._ann is not None:
                    # under a configured ANN index the new bank must
                    # carry a verified PAIRED index (built by bank_build
                    # --ann-cells): same rule as bank-under-knn — a bank
                    # swap that silently dropped to exact (or to a stale
                    # index) would change answer semantics mid-fleet
                    new_ann = self._paired_ann(bank, bank_feats,
                                               bank_labels)
            t0 = time.monotonic()
            try:
                new_engine = self._engine_factory(pretrained)
            except (ValueError, OSError, KeyError) as e:
                raise ValueError(f"cannot load {pretrained!r}: {e}") from e
            if new_engine.image_size != self.engine.image_size:
                raise ReloadRefusedError(
                    f"reload changes image_size "
                    f"{self.engine.image_size} -> {new_engine.image_size}; "
                    "the request contract is per-process, restart instead"
                )
            if tuple(new_engine.buckets) != tuple(self.engine.buckets):
                raise ReloadRefusedError(
                    f"reload changes the bucket ladder "
                    f"{tuple(self.engine.buckets)} -> "
                    f"{tuple(new_engine.buckets)}: the micro-batcher "
                    "coalesces to the OLD ladder, so a smaller one would "
                    "overflow live batches and a different one would "
                    "capture on-path"
                )
            try:
                feat_dim = new_engine.warmup()  # whole ladder, off-path
            except (ValueError, OSError, KeyError) as e:
                raise ValueError(f"cannot load {pretrained!r}: {e}") from e
            # reload drift guard: embed one fixed probe batch
            # on BOTH engines (off-path — the live engine keeps serving)
            # and refuse a checkpoint whose probe embeddings collapsed.
            # A full lincls run is the honest quality gate; this is the
            # cheap one that catches the silent failure mode training's
            # CollapseSentinel watches for, at the promotion boundary.
            probe = self._probe_stats(new_engine)
            if probe is not None and probe["probe_spread"] < \
                    self.reload_min_spread:
                raise CollapsedCheckpointError(
                    f"reload refused: probe-batch embeddings of "
                    f"{pretrained!r} are degenerate (spread "
                    f"{probe['probe_spread']:.2e} < "
                    f"{self.reload_min_spread:.2e}; drift vs live engine "
                    f"{probe['probe_drift']:.4f}) — the checkpoint looks "
                    "collapsed; keeping the previous weights"
                )
            agreement = None
            if new_knn is not None:
                # space-agreement check (generalizing the reload drift
                # guard): the NEW engine re-embeds the bank's
                # recorded seeded probe rows; a bank whose manifest lies
                # about its checkpoint scores near chance and the pair is
                # refused as a unit — never half-swapped
                agreement = self._bank_agreement(new_engine, new_meta,
                                                 feat_dim, bank)
            warm_s = time.monotonic() - t0
            if new_knn is not None:
                # one call of the new kNN off-path (same rule as
                # engine.warmup)
                self._knn_predict(np.ones((1, feat_dim), np.float32),
                                  knn=new_knn)
            # THE swap, one generation bump for BOTH halves: register the
            # new generation's bank, publish the new serving state (what
            # _run_batch reads), then bump the gen + clear the cache
            # under the gen lock. Rows embedded by the old engine stay
            # tagged with the old generation and keep voting against the
            # old bank; the first batch on the new state gets the new
            # pair — no interleaving yields a cross-space answer.
            new_gen = self._engine_gen + 1
            if new_knn is not None:
                self._knn_by_gen[new_gen] = new_knn
                for g in [g for g in self._knn_by_gen
                          if g < new_gen - 1]:
                    del self._knn_by_gen[g]  # keep current + previous
                if new_ann is not None:
                    self._ann_by_gen[new_gen] = new_ann
                    for g in [g for g in self._ann_by_gen
                              if g < new_gen - 1]:
                        del self._ann_by_gen[g]
            elif self._knn is not None:
                # bank-less swap on a bank-free service never gets here
                # (the refusal above); this re-registers the unchanged
                # bank under the new generation
                self._knn_by_gen[new_gen] = self._knn
            self._serving = _ServingState(new_engine, new_gen)
            with self._gen_lock:
                # cached rows are functions of the OLD weights; serving
                # them after the swap would silently mix model versions.
                # Increment + clear under the gen lock so no in-flight
                # old-engine request can slip a row in after the clear.
                self._engine_gen = new_gen
                if self.cache is not None:
                    self.cache.clear()
            self.engine = new_engine
            self.feat_dim = feat_dim
            if new_knn is not None:
                self._knn = new_knn
                self._bank_meta = new_meta
                self._bank_swaps += 1
                if new_ann is not None:
                    self._ann = new_ann
                    self._ann_recall = round(new_ann.recall_probe(), 4)
            entry = {
                "step": step,
                "pretrained": pretrained,
                "warm_s": round(warm_s, 3),
                "feat_dim": feat_dim,
            }
            if probe is not None:
                entry.update(probe)
            if new_knn is not None:
                entry["bank"] = bank
                entry["bank_step"] = new_meta.get("step") \
                    if new_meta else bank_step
                entry["bank_rows"] = len(new_knn["bank"])
                if agreement is not None:
                    entry["bank_agreement"] = round(agreement, 6)
            with self._lock:
                self.reloads += 1
                self._reload_history.append(entry)
                del self._reload_history[:-16]  # bounded: /stats payload
            log_event(
                "serve",
                f"hot-reloaded weights from {pretrained} "
                f"(step {step}, ladder warmed in {warm_s:.1f}s"
                + (f", bank step {entry['bank_step']}"
                   if new_knn is not None else "") + ")",
            )
            if self.registry is not None:
                self.registry.emit("event", event="serve_reload", **entry)
                if new_knn is not None:
                    self.registry.emit(
                        "bank", event="swap", step=step,
                        bank_step=entry["bank_step"],
                        rows=entry["bank_rows"], generation=new_gen,
                        agreement=entry.get("bank_agreement"),
                    )
            return entry

    def _verify_bank_pair(self, bank: str, pretrained: str,
                          bank_step: int | None):
        """Pre-factory vetting of an offered (checkpoint, bank) pair.
        Returns (features, labels, meta). Raises `BankMismatchError`
        (terminal — quarantine the pair) for integrity / binding
        failures, plain ValueError (retryable 503) for a bank whose
        manifest simply has not landed yet — the builder writes the
        manifest LAST, so 'no manifest' means 'still building': wait."""
        from moco_tpu_torch.serve import bankbuild

        try:
            feats, labels, meta = bankbuild.load_bank(bank)
        except (OSError, ValueError, KeyError) as e:
            raise ValueError(f"cannot load bank {bank!r}: {e}") from e
        if meta is None:
            raise ValueError(
                f"bank {bank!r} has no integrity manifest yet — a "
                "versioned bank writes its manifest last, so this build "
                "may still be in flight; retry once it lands"
            )
        bad = bankbuild.verify_bank(meta["bank_dir"], meta["step"])
        if bad is not None:
            raise BankMismatchError(
                f"bank {bank!r} fails its integrity manifest: {bad}"
            )
        from moco_tpu_torch.resilience.integrity import digest_file

        ckpt_sha = digest_file(pretrained)
        if meta.get("checkpoint_sha256") != ckpt_sha:
            raise BankMismatchError(
                f"bank {bank!r} (step {meta['step']}) was built against "
                f"checkpoint sha256 {meta.get('checkpoint_sha256')!r}, "
                f"but {pretrained!r} hashes to {ckpt_sha!r} — not a "
                "pair; build a paired bank with python -m moco_tpu_torch.bank_build"
            )
        if bank_step is not None and int(bank_step) != meta["step"]:
            raise BankMismatchError(
                f"offered bank_step {bank_step} != bank's recorded step "
                f"{meta['step']}"
            )
        if len(feats) != len(labels) or np.asarray(feats).ndim != 2:
            raise BankMismatchError(
                f"bank {bank!r} arrays are malformed: features "
                f"{np.asarray(feats).shape} vs labels "
                f"{np.asarray(labels).shape}"
            )
        return feats, labels, meta

    def _paired_ann(self, bank: str, bank_feats, bank_labels):
        """Load + vet the ANN index paired with an offered bank. Same
        taxonomy as the bank itself: no manifest yet -> plain ValueError
        (the builder writes the index after the bank and the
        manifest last — retry once it lands); a present-but-torn or
        mispaired index -> `BankMismatchError` (quarantine the pair)."""
        from moco_tpu_torch.serve import ann as annmod

        try:
            loaded = annmod.load_ann(bank)
        except annmod.AnnIndexError as e:
            raise BankMismatchError(
                f"paired ANN index for bank {bank!r} is bad: {e}"
            ) from e
        if loaded is None:
            raise ValueError(
                f"bank {bank!r} has no ANN index manifest yet — the "
                "index is built after the bank (manifest last), so this "
                "build may still be in flight; retry once it lands"
            )
        arrays, _manifest = loaded
        old = self._ann
        try:
            return annmod.AnnShard(
                bank_feats, bank_labels, arrays,
                shard=old.shard, shards=old.shards, nprobe=old.nprobe,
                rerank=old.rerank, temperature=old.temperature,
                num_classes=self._knn_defaults["num_classes"],
            )
        except (annmod.AnnIndexError, ValueError) as e:
            raise BankMismatchError(
                f"paired ANN index for bank {bank!r} does not fit the "
                f"bank: {e}"
            ) from e

    def _bank_agreement(self, new_engine, meta, feat_dim: int,
                        bank: str) -> float:
        """The space-agreement check: mean row-wise cosine between the
        bank's recorded probe features and the NEW engine's embedding of
        the same seeded probe rows. Raises `BankMismatchError` below the
        configured floor (or when the comparison is impossible)."""
        from moco_tpu_torch.serve import bankbuild

        if meta is None or not (meta.get("probe") or {}).get("features"):
            raise BankMismatchError(
                f"bank {bank!r} records no probe rows — cannot verify "
                "space agreement; rebuild it with python -m moco_tpu_torch.bank_build"
            )
        if meta.get("feat_dim") not in (None, feat_dim):
            raise BankMismatchError(
                f"bank {bank!r} feat_dim {meta['feat_dim']} != new "
                f"engine feat_dim {feat_dim}"
            )
        cap = new_engine.buckets[-1]  # probe rows are a deterministic
        # prefix of one rng stream, so a ladder smaller than the
        # recorded row count compares a prefix — still sound

        def embed_prefix(batch):
            return new_engine.embed(batch[: min(len(batch), cap)])

        try:
            agreement = bankbuild.probe_agreement(embed_prefix, meta)
        except (ValueError, KeyError) as e:
            raise BankMismatchError(
                f"bank {bank!r} probe rows are unusable: {e}"
            ) from e
        if agreement < self.bank_agreement_min:
            raise BankMismatchError(
                f"bank/encoder space-agreement check failed: mean probe "
                f"cosine {agreement:.4f} < floor "
                f"{self.bank_agreement_min:.4f} — the bank was not "
                f"built by this checkpoint's encoder; quarantine the "
                "pair"
            )
        return agreement

    def _probe_stats(self, new_engine) -> dict | None:
        """Cosine drift + dispersion of a fixed probe batch, new engine
        vs live. Returns None when the guard is disabled
        (`reload_probe=0`) or either dimensionality makes the comparison
        meaningless (feat-dim change: drift is undefined, and a dim
        change already implies a deliberate re-deploy).

          probe_drift   1 − mean row-wise cosine(old, new): how far the
                        embedding space moved — recorded for the
                        operator (training between exports MOVES it;
                        drift alone is not a failure)
          probe_spread  1 − ‖mean(new unit rows)‖: 0 when every probe
                        maps to one direction — rank-one collapse as
                        seen from serving. THE quarantine signal.
        """
        if self.reload_probe <= 0:
            return None
        s = new_engine.image_size
        n = min(self.reload_probe, new_engine.buckets[-1])
        if n < 2:
            return None  # one row has spread 0 by construction
        # deterministic probe (a seeded generator): the same
        # batch across reloads makes drift numbers comparable run-long
        probe = np.random.default_rng(20130613).integers(
            0, 256, size=(n, s, s, 3), dtype=np.uint8
        )
        old = self.engine.embed(probe)
        new = new_engine.embed(probe)
        if old.shape != new.shape:
            return None

        def unit(rows: np.ndarray) -> np.ndarray:
            norms = np.linalg.norm(rows, axis=-1, keepdims=True)
            return rows / np.maximum(norms, 1e-12)

        u_old, u_new = unit(old), unit(new)
        drift = 1.0 - float(np.mean(np.sum(u_old * u_new, axis=-1)))
        spread = 1.0 - float(np.linalg.norm(np.mean(u_new, axis=0)))
        return {"probe_drift": round(drift, 6),
                "probe_spread": round(spread, 6)}

    # -- telemetry -----------------------------------------------------------
    def _note_batch(self, n: int, bucket: int, wait_s: float) -> None:
        self._h_queue_wait.observe(wait_s)
        if self.tracer is not None:
            # one executed batch = one capture-window tick (the serve
            # analogue of a train step); transitions land in events.jsonl
            evt = self.tracer.tick(self.batcher.batches)
            if evt is not None and self.registry is not None:
                self.registry.emit("event", event="trace_capture", **evt)
        if (self.registry is not None
                and self.batcher.batches % self.snapshot_every == 0):
            self.registry.emit("serve", **self.stats())

    def stats(self) -> dict:
        """Cumulative snapshot — the `/stats` payload AND the `kind:
        "serve"` telemetry record (the report reads the LAST one)."""
        b = self.batcher
        with self._lock:
            requests, served = self.requests, self.served
        out = {
            "requests": requests,
            "served": served,
            "shed_overload": b.shed_overload,
            "shed_deadline": b.shed_deadline,
            "batch_errors": b.batch_errors,
            "batches": b.batches,
            "occupancy_mean": round(b.occupancy_mean, 4),
            "queue_depth": b.queue_depth,
            "buckets": list(b.buckets),
            "latency_ms": self._h_latency.percentiles_ms(),
            "queue_wait_ms": self._h_queue_wait.percentiles_ms(),
            "draining": self.draining,
            "uptime_s": round(time.monotonic() - self._started, 1),
            # per-tier admission breakdown; the flat
            # shed_overload/shed_deadline above stay cross-tier TOTALS
            "tiers": {
                "submitted": dict(b.submitted_by_tier),
                "shed_overload": dict(b.shed_overload_by_tier),
                "shed_deadline": dict(b.shed_deadline_by_tier),
                "queue_depth": b.queue_depth_by_tier,
            },
        }
        if self._ann is not None:
            with self._lock:
                candidate_calls = self.ann_candidate_calls
            out["ann"] = dict(
                self._ann.stats(),
                recall_probe=self._ann_recall,
                candidate_calls=candidate_calls,
            )
        with self._lock:
            if self.reloads:
                out["reloads"] = self.reloads
                out["reload_history"] = list(self._reload_history)
        if self.cache is not None:
            out["cache"] = {
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "hit_rate": round(self.cache.hit_rate, 4),
                "entries": self.cache.entries,
                "bytes": self.cache.cached_bytes,
            }
        trace = self.trace_state()
        if trace is not None:
            out["trace"] = trace
        if self._knn is not None:
            out["bank"] = self.bank_info()
        return out

    def bank_info(self) -> dict:
        """Which embedding space is this replica answering from? The
        `GET /admin/bank` payload and the `/stats` bank block: bank
        version (step + manifest hash), the checkpoint it was built against,
        row count, and the last swap generation. A plain
        --knn-bank npz (no manifest) reports only size + generation."""
        with self._lock:
            swaps = self._bank_swaps
        knn, meta = self._knn, self._bank_meta
        out: dict = {"configured": knn is not None}
        if knn is None:
            return out
        out.update({
            "rows": int(len(knn["bank"])),
            "feat_dim": int(knn["bank"].shape[1]),
            "generation": self._engine_gen,
            "swaps": swaps,
        })
        if meta is not None:
            out.update({
                "bank_step": meta.get("step"),
                "manifest_sha256": meta.get("manifest_sha256"),
                "checkpoint_sha256": meta.get("checkpoint_sha256"),
                "path": meta.get("path"),
            })
        return out

    def trace_state(self) -> dict | None:
        """Capture-window state for /healthz and /stats ("currently
        profiling?" without reading events.jsonl); None when untraced."""
        return self.tracer.capture_state() if self.tracer is not None else None

    # -- shutdown ------------------------------------------------------------
    def drain(self, timeout_s: float = 60.0) -> bool:
        """Reject new work, complete everything accepted, flush the final
        telemetry snapshot. Idempotent. Returns False when in-flight work
        outlived `timeout_s` (the batcher is then closed non-draining and
        leftovers get a structured rejection — never a silent drop)."""
        self.draining = True
        completed = self.batcher.drain(timeout_s)
        if not completed:
            log_event(
                "serve",
                f"drain timed out after {timeout_s:.0f}s; rejecting the "
                "remainder with structured errors",
            )
        self.batcher.close(drain=False)
        if self.registry is not None:
            self.registry.emit("serve", final=True, **self.stats())
            self.registry.flush()
        if self.tracer is not None:
            self.tracer.flush()  # land any buffered spans with the drain
        return completed
