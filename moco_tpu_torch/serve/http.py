"""stdlib HTTP front end over `EmbedService` (port of
`moco_tpu/serve/http.py`: the same routes, status codes, JSON keys and
error bodies).

One thread per connection (`ThreadingHTTPServer`): each request blocks in
`service.embed` until its coalesced batch resolves, which is exactly the
concurrency shape the micro-batcher feeds on — N in-flight HTTP requests
ARE the batch. No web framework: the container bakes no server deps, and
the protocol is four routes of JSON.

    POST /v1/embed   {"image_b64": <raw uint8 RGB bytes>, "shape": [S,S,3]}
                     (or {"pixels": nested list}; optional "deadline_ms",
                     optional "tier": "interactive"|"batch" — the
                     admission lane)
                 →   200 {"embedding": [...], "cached": bool}
    POST /v1/knn     same body → 200 {"class": int, "cached": bool}
                     (+"embedding" when "return_embedding" is true).
                     With {"candidates": true, "embedding": [...]} —
                     the fleet router's ANN fan-out leg — answers this
                     replica's shard-local candidates instead:
                     {"candidates": [[sim, label], ...], "temperature",
                     "k", "num_classes", "shard", "shards"}
    POST /admin/reload  {"pretrained": <path>, "step": <int>?,
                     "bank": <path>?, "bank_step": <int>?} → hot weight
                     reload: build + warm a new engine
                     off-path, atomically swap between micro-batches.
                     With "bank", the dual swap: engine +
                     kNN bank roll together under one generation bump.
                     200 on swap; 409 {"error": "reload_refused"} when
                     this process's config can never accept it (bank
                     configured but no pair offered — body carries
                     "bank_step", the serving bank's recorded step —
                     image_size/ladder change; terminal, the fleet
                     stops retrying); 409 {"error":
                     "reload_bank_mismatch"} when the offered
                     (checkpoint, bank) pair fails verification — the
                     fleet quarantines the pair and rolls back; 503
                     {"error": "reload_failed"} when the checkpoint
                     couldn't be loaded/warmed (possibly transient —
                     retried). Old weights keep serving on every
                     failure. OPERATOR-ONLY: the fleet router never
                     proxies /admin/* — only the fleet supervisor (or an
                     operator on the replica's own port) reaches it.
    GET  /admin/bank 200 <service.bank_info()> — which embedding space
                     this replica answers from
    GET  /healthz    200 {"status": "ok"} | 503 {"status": "draining"}
    GET  /stats      200 <service.stats()>

Rejections are STRUCTURED, never hangs: the batcher's typed errors map to
HTTP statuses with a machine-readable body — 503 `{"error":
"overloaded", "retry_after_ms": ...}`, 504 `{"error":
"deadline_exceeded"}`, 503 `{"error": "draining"}` — so a load balancer
or client can distinguish shed from broken."""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from moco_tpu_torch.serve.batcher import RejectionError
from moco_tpu_torch.serve.service import (
    BankMismatchError,
    CollapsedCheckpointError,
    ReloadRefusedError,
)


def decode_image(req: dict) -> np.ndarray:
    """Request body → one uint8 image array; ValueError on any malformed
    input (the front end maps it to 400, never a traceback)."""
    if "image_b64" in req:
        shape = req.get("shape")
        if (not isinstance(shape, (list, tuple)) or len(shape) != 3):
            raise ValueError('image_b64 needs "shape": [h, w, 3]')
        try:
            buf = base64.b64decode(req["image_b64"], validate=True)
        except (ValueError, TypeError) as e:
            raise ValueError(f"image_b64 is not valid base64: {e}")
        arr = np.frombuffer(buf, np.uint8)
        expected = int(np.prod([int(s) for s in shape]))
        if arr.size != expected:
            raise ValueError(
                f"image_b64 carries {arr.size} bytes, shape {shape} "
                f"needs {expected}"
            )
        return arr.reshape([int(s) for s in shape])
    if "pixels" in req:
        try:
            return np.asarray(req["pixels"], np.uint8)
        except (ValueError, TypeError) as e:
            raise ValueError(f"pixels is not a uint8 image array: {e}")
    raise ValueError('body needs "image_b64"+"shape" or "pixels"')


def _make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        # keep-alive: closed-loop clients (serve_bench) reuse connections
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102
            # per-request stderr lines drown real events under load; the
            # structured channel is service.stats()/telemetry
            pass

        def _send(self, status: int, obj: dict) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _maybe_wedge(self) -> None:
            """Chaos `wedge_at_request` (the fleet drill): once the
            service is wedged, EVERY route — /healthz included — accepts
            the connection and then never answers. From outside this is
            exactly a stuck event loop / dead device: the fleet
            supervisor's probe-staleness kill is the only way out."""
            while service.wedged:
                time.sleep(3600.0)

        def do_GET(self):
            self._maybe_wedge()
            if self.path == "/healthz":
                # trace state: a balancer/operator sees
                # "currently profiling" straight from the health probe.
                # `draining` read ONCE: a drain flipping between body and
                # status would send a 503 whose body still says ok
                draining = service.draining
                trace = getattr(service, "trace_state", lambda: None)()
                if draining:
                    body = {"status": "draining"}
                else:
                    body = {"status": "ok",
                            "queue_depth": service.batcher.queue_depth}
                if trace is not None:
                    body["trace"] = trace
                self._send(503 if draining else 200, body)
            elif self.path == "/stats":
                self._send(200, service.stats())
            elif self.path == "/admin/bank":
                self._send(200, service.bank_info())
            else:
                self._send(404, {"error": "not_found", "path": self.path})

        def do_POST(self):
            self._maybe_wedge()
            if self.path == "/admin/reload":
                self._admin_reload()
                return
            if self.path not in ("/v1/embed", "/v1/knn"):
                # body must still be consumed on HTTP/1.1 keep-alive
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                self._send(404, {"error": "not_found", "path": self.path})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                deadline_ms = req.get("deadline_ms")
                deadline_s = (
                    float(deadline_ms) / 1e3 if deadline_ms else None
                )
                tier = req.get("tier", "interactive")
                if tier not in ("interactive", "batch"):
                    raise ValueError(
                        f'unknown tier {tier!r} ("interactive" or "batch")'
                    )
                # ANN candidate probe: the fleet router's
                # fan-out leg carries an EMBEDDING, not an image — no
                # batcher, no device call, pure index search
                candidates = (self.path == "/v1/knn"
                              and req.get("candidates"))
                image = None if candidates else decode_image(req)
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": "bad_request", "detail": str(e)})
                return
            try:
                if candidates:
                    emb = req.get("embedding")
                    if not isinstance(emb, list) or not emb:
                        raise ValueError(
                            'candidates mode needs "embedding": [...]'
                        )
                    self._send(200, service.ann_candidates(emb))
                    return
                if self.path == "/v1/knn":
                    cls_id, embedding, cached = service.classify(
                        image, deadline_s, tier=tier
                    )
                    resp = {"class": cls_id, "cached": cached}
                    if req.get("return_embedding"):
                        resp["embedding"] = [float(v) for v in embedding]
                else:
                    embedding, cached = service.embed(image, deadline_s,
                                                      tier=tier)
                    resp = {"embedding": [float(v) for v in embedding],
                            "cached": cached}
                self._send(200, resp)
            except RejectionError as e:
                self._send(e.http_status,
                           {"error": e.code, "detail": str(e), **e.fields})
            except ValueError as e:  # e.g. wrong resolution for this model
                self._send(400, {"error": "bad_request", "detail": str(e)})
            except Exception as e:  # a handler crash must answer, not hang
                self._send(500, {"error": "internal", "detail": repr(e)})

        def _admin_reload(self):
            """Hot weight reload. Failures answer 409 with the
            reason — the old weights keep serving either way, and the
            caller (the fleet supervisor's reload roll) distinguishes a
            bad checkpoint from a dead replica by the structured body."""
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict) or not req.get("pretrained"):
                    raise ValueError('body needs {"pretrained": <path>}')
                step = req.get("step")
                step = int(step) if step is not None else None
                bank = req.get("bank")
                bank = str(bank) if bank else None
                bank_step = req.get("bank_step")
                bank_step = int(bank_step) if bank_step is not None else None
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                # a malformed REQUEST (non-integer step included) is the
                # client's bug, not a checkpoint failure: 400, not 409
                self._send(400, {"error": "bad_request", "detail": str(e)})
                return
            if service.draining:
                self._send(503, {"error": "draining"})
                return
            try:
                entry = service.reload(str(req["pretrained"]), step,
                                       bank=bank, bank_step=bank_step)
                self._send(200, {"status": "reloaded", **entry})
            except BankMismatchError as e:
                # dual swap: the offered (checkpoint, bank)
                # PAIR is bad — its own code so the fleet quarantines
                # the pair as a unit and rolls back half-swapped
                # replicas (checked before ReloadRefusedError: it IS one)
                self._send(409, {"error": "reload_bank_mismatch",
                                 "detail": str(e)})
            except CollapsedCheckpointError as e:
                # drift guard: the CHECKPOINT is bad, not this
                # process's config — its own error code so the fleet
                # quarantines the step instead of merely not retrying
                self._send(409, {"error": "reload_collapsed",
                                 "detail": str(e)})
            except ReloadRefusedError as e:
                # TERMINAL for this process config (bank without a pair,
                # image_size, ladder): 409 — the fleet stops retrying
                # this step here. Under a configured versioned bank the
                # body names the bank's recorded checkpoint step so the
                # operator sees WHICH pair is missing its other half.
                body = {"error": "reload_refused", "detail": str(e)}
                if getattr(e, "bank_step", None) is not None:
                    body["bank_step"] = e.bank_step
                self._send(409, body)
            except ValueError as e:
                # load/warmup failure: possibly transient (NFS blip, a
                # momentary OOM) — 503 so the fleet's converge loop
                # retries on its next pass
                self._send(503, {"error": "reload_failed", "detail": str(e)})
            except Exception as e:  # must answer, never hang the roll
                self._send(503, {"error": "reload_failed", "detail": repr(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # listen backlog: socketserver's default of 5 resets connections the
    # moment a few dozen closed-loop clients reconnect at once (urllib
    # opens a fresh TCP connection per request) — the admission queue, not
    # the kernel backlog, is where this service sheds load
    request_queue_size = 128


class ServeFrontend:
    """Owns the `ThreadingHTTPServer`; `port=0` binds an ephemeral port
    (tests, in-process bench) and exposes the real one as `.port`."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.server = _Server((host, port), _make_handler(service))
        self.host, self.port = self.server.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True, name="serve-http"
        )
        self._thread.start()

    def shutdown(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
