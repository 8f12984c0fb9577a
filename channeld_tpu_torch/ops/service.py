"""gRPC sidecar exposing the spatial decision plane on the GPU.

The port of ``channeld_tpu/ops/service.py``, with the same wire
behaviour: an external gateway ships position deltas + query and
subscription changes in a StepRequest and receives compacted decisions.
Service wiring is hand-rolled generic handlers over the message schema
in ``service_pb2`` (a byte-identical copy of the JAX package's, so both
packages share one descriptor in one process).

Serving properties (as in the reference):
- Interest results are DELTA: only connections whose query changed
  since the caller's last step are returned (request fullInterest for a
  complete sync). Dirty tracking is per caller (per stream / per unary
  peer); a caller's first step is automatically a full sync.
- Steps serialize per engine (not on a global lock).
- Optional shared-secret auth: set ``auth_token`` (or the
  CHTPU_SIDECAR_TOKEN env var) and every call must carry it as
  ``x-chtpu-auth`` metadata.
- StepStream: a bidirectional pipeline (one response per request) that
  answers a malformed request in-band.

Port specifics: the engine runs on ``device`` (``cuda`` unless the
server is created with ``device="cpu"``); a step reads the tick back
with one blob transfer, plus one transfer of just the interest rows it
reports. ``meshDevices``/``meshHosts`` shard the engine over that many
devices of the server's kind (``parallel.mesh.mesh_from_config``); a
mesh wider than the cards present answers INVALID_ARGUMENT, as the JAX
sidecar does. ``grpc`` and
``service_pb2`` (protobuf) are imported lazily, inside this module only,
so ``channeld_tpu_torch.ops`` imports without them; ``install`` and
``decide`` drive the same decision pass in-process without either.

Ingest: a request's position updates become two columns, ids and xyz,
applied in one ``SpatialEngine.update_entities`` call. A protobuf
request's columns are decoded from its bytes in one native pass
(``native/step_columns.cc``, built at ``install``); a request of plain
objects, or any request on a host where the decoder cannot be built, has
its fields read in Python (``_update_columns``).

With the flight recorder on (``core/tracing.py``), the unary Step
records ``sidecar.step`` around its stages: ``sidecar.ingest`` (its
``count``: the request's updates plus removals), ``sidecar.edits``, the
engine's spans, ``sidecar.interest``, ``sidecar.due`` and
``sidecar.respond`` (doc/observability.md). ``main`` dumps the ring on
SIGUSR2 and at exit.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from concurrent import futures
from typing import NamedTuple, Optional

import numpy as np

from ..core.tracing import recorder as _trace
from ..utils.devices import resolve_device
from ..utils.logger import get_logger
from .spatial_ops import AOI_SPOTS, GridSpec

logger = get_logger("ops.service")

SERVICE_NAME = "chtpu.ops.SpatialDecision"
AUTH_METADATA_KEY = "x-chtpu-auth"
# Distinguishes unary callers for delta-interest tracking. context.peer()
# alone is NOT enough: grpc-python shares subchannels between channels
# with the same target+args, so two client objects in one process can
# present the same peer address.
CALLER_METADATA_KEY = "x-chtpu-caller"


def _pb():
    from . import service_pb2

    return service_pb2


class _StepValidationError(ValueError):
    """A malformed StepRequest; unary aborts, streaming reports in-band."""


class _ConfigError(ValueError):
    """A ConfigRequest this engine cannot serve (INVALID_ARGUMENT)."""


_DIRTY_CALLER_TTL = 300.0  # forget unary peers silent this long
_MAX_DIRTY_CALLERS = 64  # hard cap: caller ids are client-controlled


class StepDecision(NamedTuple):
    """One step's decisions, the content of a StepResponse."""

    now_ms: int
    handover_count: int
    handovers: list  # [(entity_id, src_cell, dst_cell)]
    cell_counts: np.ndarray  # i32[C]
    interests: list  # [(conn_id, cells u32[k], dists u32[k])]
    due_sub_ids: list  # [sub_id]


class _EngineState:
    """One engine plus ALL its serving state, swapped atomically on
    Configure: a step racing a swap holds the doomed state's lock and
    touches only that state.

    Dirty-interest tracking is PER CALLER (one set per stream, one per
    unary peer): a query mutation marks the conn dirty in every caller's
    set, and each caller's step drains only its own. A caller seen for
    the first time starts with every standing query dirty, so its first
    step is a full sync without needing fullInterest."""

    def __init__(self, engine):
        self.engine = engine
        self.lock = threading.Lock()
        self.sub_map: dict[int, int] = {}
        self._dirty_sets: dict[object, set[int]] = {}
        self._dirty_seen: dict[object, float] = {}
        self._pinned: set[object] = set()  # stream callers: no TTL/evict

    def dirty_for(self, caller: object, pinned: bool = False) -> set[int]:
        """The caller's own dirty set (created on first use). Bounded two
        ways, since caller ids are client-controlled: unary peers unseen
        within the TTL are pruned, and at the hard cap the longest-unseen
        unary peer is evicted (it full-resyncs on return). ``pinned``
        callers (open streams) are exempt from both; stream teardown
        drops them explicitly."""
        now = time.monotonic()
        dirty = self._dirty_sets.get(caller)
        if dirty is None:
            # Only unpinned callers count toward (and make room in) the cap.
            if not pinned:
                unpinned = [k for k in self._dirty_seen
                            if k not in self._pinned]
                if len(unpinned) >= _MAX_DIRTY_CALLERS:
                    self.drop_caller(min(unpinned, key=self._dirty_seen.get))
            dirty = set(self.engine._q_of_conn.keys())
            self._dirty_sets[caller] = dirty
            if pinned:
                self._pinned.add(caller)
        self._dirty_seen[caller] = now
        for stale in [k for k, t in self._dirty_seen.items()
                      if now - t > _DIRTY_CALLER_TTL
                      and k not in self._pinned]:
            self.drop_caller(stale)
        return dirty

    def drop_caller(self, caller: object) -> None:
        self._dirty_sets.pop(caller, None)
        self._dirty_seen.pop(caller, None)
        self._pinned.discard(caller)

    def mark_dirty(self, conn_id: int) -> None:
        for dirty in self._dirty_sets.values():
            dirty.add(conn_id)

    def unmark_dirty(self, conn_id: int) -> None:
        for dirty in self._dirty_sets.values():
            dirty.discard(conn_id)


def _update_columns(updates, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``n`` position updates as (ids u32[n], xyz f32[n, 3]), read
    field by field: the ingest's columns when there are no wire bytes to
    decode, or no decoder."""
    ids = np.fromiter((u.entityId for u in updates), np.uint32, n)
    xyz = np.fromiter((v for u in updates for v in (u.x, u.y, u.z)), np.float32, 3 * n)
    return ids, xyz.reshape(n, 3)


class SpatialDecisionServicer:
    def __init__(self, auth_token: Optional[str] = None, device=None):
        """``device``: where every configured engine runs; ``cuda`` by
        default (raises without a CUDA device), ``"cpu"`` only when
        asked for."""
        self.device = resolve_device(device)
        self.auth_token = auth_token
        # Guards state swap only; step traffic serializes on the state's
        # own lock so Configure never queues behind a slow device step.
        self._swap_lock = threading.Lock()
        self._state: Optional[_EngineState] = None
        # The decoder of a request's position updates (native
        # step_columns), loaded at install; None: read in Python.
        self._step_columns = None

    @property
    def engine(self):
        state = self._state
        return state.engine if state is not None else None

    # ---- auth --------------------------------------------------------

    def _check_auth(self, context) -> None:
        if not self.auth_token:
            return
        import hmac

        meta = dict(context.invocation_metadata() or ())
        if not hmac.compare_digest(
            meta.get(AUTH_METADATA_KEY, ""), self.auth_token
        ):
            import grpc

            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing or wrong x-chtpu-auth token")

    # ---- in-process surface ------------------------------------------

    def install(self, request) -> None:
        """Build and swap in a fresh engine for a ConfigRequest (or any
        object with its fields). Raises _ConfigError for a mesh the
        devices present cannot hold."""
        from ..native import load_step_columns
        from ..parallel.mesh import mesh_from_config
        from .engine import SpatialEngine

        try:
            mesh = mesh_from_config(request.meshDevices, request.meshHosts or 1,
                                    device=self.device)
        except ValueError as e:
            raise _ConfigError(str(e)) from e
        engine = SpatialEngine(
            GridSpec(
                offset_x=request.worldOffsetX,
                offset_z=request.worldOffsetZ,
                cell_w=request.gridWidth,
                cell_h=request.gridHeight,
                cols=request.gridCols,
                rows=request.gridRows,
            ),
            entity_capacity=request.entityCapacity or (1 << 17),
            query_capacity=request.queryCapacity or (1 << 12),
            sub_capacity=request.subCapacity or (1 << 16),
            mesh=mesh,
            device=self.device,
        )
        # Builds the kernels on CUDA, so the first Step does not pay nvcc.
        engine.warmup()
        self._step_columns = load_step_columns()  # g++ here, not in a Step
        with self._swap_lock:
            self._state = _EngineState(engine)
        logger.info(
            "configured engine on %s: %dx%d grid, %d entity slots, mesh=%s",
            self.device, request.gridCols, request.gridRows,
            request.entityCapacity or (1 << 17),
            f"{request.meshDevices}dev" if request.meshDevices else "none",
        )

    def decide(self, request, caller: object = "in-process") -> StepDecision:
        """One decision pass for a StepRequest (or any object with its
        fields), as the given caller, without gRPC."""
        state = self._state
        if state is None:
            raise RuntimeError("not configured")
        with state.lock:
            return self._decide(state, request, caller)

    # ---- rpc handlers ------------------------------------------------

    def configure(self, request, context):
        self._check_auth(context)
        try:
            self.install(request)
        except _ConfigError as e:
            import grpc

            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return _pb().Empty()

    def _current_state(self, context) -> _EngineState:
        with self._swap_lock:
            state = self._state
        if state is None:
            import grpc

            context.abort(grpc.StatusCode.FAILED_PRECONDITION, "not configured")
        return state

    def step(self, request, context):
        t0 = _trace.now() if _trace.enabled else 0
        self._check_auth(context)
        state = self._current_state(context)
        # One dirty set per unary caller: the x-chtpu-caller metadata if
        # the gateway sends one, else the peer address.
        meta = dict(context.invocation_metadata() or ())
        caller = ("unary", meta.get(CALLER_METADATA_KEY) or context.peer())
        try:
            with state.lock:
                resp = self._do_step(state, request, caller)
        except _StepValidationError as e:
            import grpc

            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return None
        if t0:
            _trace.span("sidecar.step", t0)
        return resp

    def step_stream(self, request_iterator, context):
        """One response per request; same semantics as Step, except a
        malformed request answers in-band (StepResponse.error) instead of
        killing the pipeline with its in-flight steps."""
        self._check_auth(context)
        caller = object()  # one dirty set per stream, dropped at stream end
        state = None
        try:
            for request in request_iterator:
                state = self._current_state(context)
                try:
                    # Yield OUTSIDE the lock: a stalled stream consumer
                    # must not hold the engine lock.
                    with state.lock:
                        resp = self._do_step(state, request, caller,
                                             pinned=True)
                except _StepValidationError as e:
                    resp = _pb().StepResponse(engineNowMs=request.nowMs,
                                              error=str(e))
                yield resp
        finally:
            if state is not None:
                with state.lock:
                    state.drop_caller(caller)

    # ---- the decision pass -------------------------------------------

    def _do_step(self, state: _EngineState, request, caller: object,
                 pinned: bool = False):
        d = self._decide(state, request, caller, pinned)
        t0 = _trace.now() if _trace.enabled else 0
        resp = _pb().StepResponse(engineNowMs=d.now_ms)
        resp.handoverCount = d.handover_count
        for entity_id, src, dst in d.handovers:
            resp.handovers.add(entityId=entity_id, srcCell=src, dstCell=dst)
        resp.cellCounts.extend(d.cell_counts.astype(np.uint32).tolist())
        for conn_id, cells, dists in d.interests:
            ir = resp.interests.add(connId=conn_id)
            ir.cells.extend(cells.tolist())
            ir.dists.extend(dists.tolist())
        resp.dueSubIds.extend(d.due_sub_ids)
        if t0:
            _trace.span("sidecar.respond", t0)
        return resp

    def _decide(self, state: _EngineState, request, caller: object,
                pinned: bool = False) -> StepDecision:
        eng = state.engine
        dirty = state.dirty_for(caller, pinned=pinned)
        t0 = _trace.now() if _trace.enabled else 0
        updates = request.updates
        n = len(updates)
        columns = None
        if n and self._step_columns is not None and hasattr(request, "SerializeToString"):
            # A protobuf request: its updates as columns, from its bytes.
            columns = self._step_columns(request.SerializeToString(), n)
        if columns is None:
            columns = _update_columns(updates, n)
        eng.update_entities(*columns)
        for eid in request.removedEntityIds:
            eng.remove_entity(eid)
        if t0:
            _trace.span("sidecar.ingest", t0, count=n + len(request.removedEntityIds))
            t0 = _trace.now()
        for q in request.queries:
            if q.kind == AOI_SPOTS:
                if len(q.spotX) != len(q.spotZ):
                    raise _StepValidationError(
                        f"spotX/spotZ length mismatch "
                        f"({len(q.spotX)} vs {len(q.spotZ)})"
                    )
                eng.set_spots_query(
                    q.connId, list(zip(q.spotX, q.spotZ)), list(q.spotDists)
                )
                state.mark_dirty(q.connId)
                continue
            direction = (q.dirX, q.dirZ)
            if direction == (0.0, 0.0):
                direction = (1.0, 0.0)  # unset; a zero vector is invalid
            eng.set_query(
                q.connId, q.kind, (q.centerX, q.centerZ),
                (q.extentX, q.extentZ), direction, q.angle,
            )
            state.mark_dirty(q.connId)
        for conn_id in request.removedQueryConnIds:
            eng.remove_query(conn_id)
            state.unmark_dirty(conn_id)
        sub_map = state.sub_map
        for sub in request.addSubscriptions:
            sub_map[sub.subId] = eng.add_subscription(
                sub.fanOutIntervalMs, sub.firstDueMs
            )
        for sub_id in request.removeSubIds:
            slot = sub_map.pop(sub_id, None)
            if slot is not None:
                eng.remove_subscription(slot)
        if t0:
            _trace.span("sidecar.edits", t0)

        now_ms = request.nowMs or eng.now_ms()
        result = eng.tick(now_ms)
        # The tick's one blob transfer: handovers, counts and due bits.
        count, _, counts, due = eng.consume(result)
        handovers = eng.handover_list(result)
        # Delta interest: AOI masks are a pure function of query geometry,
        # so only changed queries need transfer — step cost is flat in
        # the standing query population.
        t0 = _trace.now() if _trace.enabled else 0
        if request.fullInterest:
            report_conns = list(eng._q_of_conn.keys())
        else:
            report_conns = [c for c in dirty if c in eng._q_of_conn]
        interests = []
        if report_conns:
            rows = eng.interest_rows(
                result, [eng._q_of_conn[c] for c in report_conns])
            for conn_id, drow in zip(report_conns, rows):
                cells = np.nonzero(drow >= 0)[0]
                interests.append((conn_id, cells.astype(np.uint32),
                                  drow[cells].astype(np.uint32)))
        dirty.clear()
        if t0:
            _trace.span("sidecar.interest", t0)
            t0 = _trace.now()
        slot_to_sub = {slot: sub_id for sub_id, slot in sub_map.items()}
        due_ids = []
        for slot in np.nonzero(due)[0]:
            sub_id = slot_to_sub.get(int(slot))
            if sub_id is not None:
                due_ids.append(sub_id)
        if t0:
            _trace.span("sidecar.due", t0)
        return StepDecision(now_ms, count, handovers, counts, interests, due_ids)


def create_server(port: int = 50051, max_workers: int = 4,
                  auth_token: Optional[str] = None, device=None):
    """Build (but don't start) the gRPC server; returns
    (server, servicer, bound_port). ``auth_token`` defaults to the
    CHTPU_SIDECAR_TOKEN env var; empty = no auth. ``device``: ``cuda``
    by default, ``"cpu"`` only when asked for."""
    import grpc

    pb = _pb()
    if auth_token is None:
        auth_token = os.environ.get("CHTPU_SIDECAR_TOKEN", "")
    servicer = SpatialDecisionServicer(auth_token=auth_token or None,
                                       device=device)
    handlers = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "Configure": grpc.unary_unary_rpc_method_handler(
                servicer.configure,
                request_deserializer=pb.ConfigRequest.FromString,
                response_serializer=pb.Empty.SerializeToString,
            ),
            "Step": grpc.unary_unary_rpc_method_handler(
                servicer.step,
                request_deserializer=pb.StepRequest.FromString,
                response_serializer=pb.StepResponse.SerializeToString,
            ),
            "StepStream": grpc.stream_stream_rpc_method_handler(
                servicer.step_stream,
                request_deserializer=pb.StepRequest.FromString,
                response_serializer=pb.StepResponse.SerializeToString,
            ),
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((handlers,))
    bound = server.add_insecure_port(f"[::]:{port}")
    if bound == 0:
        raise OSError(f"failed to bind sidecar port {port}")
    return server, servicer, bound


class SpatialDecisionClient:
    """Typed client for gateways written in Python (external gateways use
    the proto schema directly).

    Unary calls carry a deadline, and transient failures retry with
    deterministic exponential backoff before surfacing. Configure is
    idempotent, so a timed-out call retries; Step is NOT retried on
    DEADLINE_EXCEEDED — a step that executed server-side has already
    drained this caller's dirty set and allocated any requested
    subscription slots. StepStream is not retried at all: a broken
    stream loses its per-caller delta state, so the caller must reopen
    and accept the automatic full resync."""

    _RETRYABLE = {
        "Configure": ("UNAVAILABLE", "DEADLINE_EXCEEDED"),
        "Step": ("UNAVAILABLE",),  # non-idempotent: see class docstring
    }

    def __init__(self, target: str = "127.0.0.1:50051",
                 auth_token: Optional[str] = None,
                 timeout_s: float = 5.0, max_retries: int = 3,
                 backoff_s: float = 0.1):
        import grpc

        pb = _pb()
        self.target = target
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._channel = grpc.insecure_channel(target)
        meta = [(CALLER_METADATA_KEY, uuid.uuid4().hex)]
        if auth_token:
            meta.append((AUTH_METADATA_KEY, auth_token))
        self._metadata = tuple(meta)
        self._configure = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Configure",
            request_serializer=pb.ConfigRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )
        self._step = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Step",
            request_serializer=pb.StepRequest.SerializeToString,
            response_deserializer=pb.StepResponse.FromString,
        )
        self._step_stream = self._channel.stream_stream(
            f"/{SERVICE_NAME}/StepStream",
            request_serializer=pb.StepRequest.SerializeToString,
            response_deserializer=pb.StepResponse.FromString,
        )

    def _call_with_retry(self, method_name: str, fn, request):
        """Deadline + deterministic exponential backoff on transient
        codes (no jitter: replays see the same retry schedule)."""
        import grpc

        retryable = tuple(
            getattr(grpc.StatusCode, c)
            for c in self._RETRYABLE.get(method_name, ())
        )
        delay = self.backoff_s
        attempt = 0
        while True:
            try:
                return fn(request, metadata=self._metadata,
                          timeout=self.timeout_s)
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code not in retryable or attempt >= self.max_retries:
                    raise
                attempt += 1
                logger.warning(
                    "sidecar %s transient failure (%s); retry %d/%d in %.2fs",
                    method_name, code, attempt, self.max_retries, delay,
                )
                time.sleep(delay)
                delay *= 2

    def configure(self, **kwargs) -> None:
        self._call_with_retry(
            "Configure", self._configure, _pb().ConfigRequest(**kwargs)
        )

    def step(self, request):
        return self._call_with_retry("Step", self._step, request)

    def step_stream(self, request_iterator):
        """Returns the response iterator for a bidirectional pipeline."""
        return self._step_stream(request_iterator, metadata=self._metadata)

    def close(self) -> None:
        self._channel.close()


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="channeld-tpu spatial decision sidecar (PyTorch/CUDA)")
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--auth-token", type=str, default=None,
                   help="shared secret; defaults to $CHTPU_SIDECAR_TOKEN")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args()
    from ..core import tracing

    # The flight recorder's operator exits, as the gateway has them:
    # SIGUSR2 dumps the ring as Perfetto JSON, and so does the exit.
    tracing.install_trace_dump_signal()
    tracing.register_shutdown_dump()
    server, _, bound = create_server(args.port, auth_token=args.auth_token,
                                     device=args.device)
    server.start()
    logger.info("spatial decision sidecar listening on :%d (%s)", bound,
                args.device)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
