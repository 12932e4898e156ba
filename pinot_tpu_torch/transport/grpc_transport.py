"""gRPC data-plane transport: broker ↔ server query RPC.

Equivalent of the reference's query wire (Netty + thrift-compact
InstanceRequest, InstanceRequestHandler.java:54-76, and the gRPC streaming
server GrpcQueryServer.java:53,117 / server.proto:43-59). One method:

    /pinot.PinotQueryServer/Submit   bytes → bytes

Request: JSON {sql, segments: [...], requestId, brokerId, traceEnabled}
(the InstanceRequest analog — the query ships as SQL text the way the
reference ships the PinotQuery AST). Response: DataTable bytes
(engine/datatable.py). Raw-bytes generic handlers avoid a protoc build
step while keeping a real gRPC wire — HTTP/2 framing, deadlines, and
multiplexed channels all apply.

``grpc`` is imported where a transport or channel is built, so the
broker, server and controller modules import without it.
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Callable, Optional

SUBMIT_METHOD = "/pinot.PinotQueryServer/Submit"
SUBMIT_STREAMING_METHOD = "/pinot.PinotQueryServer/SubmitStreaming"
# peer segment download (PeerServerSegmentFinder role): a server streams a
# tar of a segment dir it serves to a replica whose deep-store copy is
# unreachable
FETCH_SEGMENT_METHOD = "/pinot.PinotQueryServer/FetchSegment"
# distributed stage-2 exchange (mailbox leapfrog — the reference snapshot
# has no pinot-query-runtime): ExecuteStage is the broker→server "run your
# slice of stage 2" request; ExchangeTransfer is the server→server
# partition payload (query2/exchange.py wire codec)
EXECUTE_STAGE_METHOD = "/pinot.PinotQueryServer/ExecuteStage"
EXCHANGE_TRANSFER_METHOD = "/pinot.PinotQueryServer/ExchangeTransfer"

# wide-result headroom: gRPC's 4 MB default inbound cap turns a
# multi-million-row buffered SELECT into RESOURCE_EXHAUSTED before the
# broker ever sees the DataTable. Mirror the reference's GrpcConfig
# maxInboundMessageSizeBytes default (128 MB) on both ends of the wire;
# the streaming path stays the right answer for results bigger than one
# message, this just keeps the unary path honest up to the same bound.
MAX_INBOUND_MESSAGE_BYTES = 128 * 1024 * 1024
_SIZE_OPTIONS = (
    ("grpc.max_receive_message_length", MAX_INBOUND_MESSAGE_BYTES),
    ("grpc.max_send_message_length", MAX_INBOUND_MESSAGE_BYTES),
)


def make_instance_request(sql: str, segments: list, request_id: int,
                          broker_id: str = "", trace: bool = False,
                          table: str = None, time_filter: dict = None,
                          timeout_ms: float = None, trace_id: str = None,
                          attempt: str = "primary", workload: str = None,
                          priority: str = None) -> bytes:
    """``table``: physical table override (hybrid split sends the same SQL to
    X_OFFLINE and X_REALTIME); ``time_filter``: {column, op le|gt, value}
    AND-ed server-side (the time-boundary predicate); ``timeout_ms``: the
    query's REMAINING deadline budget at send time — the server bounds
    every downstream wait by it and answers QUERY_TIMEOUT instead of
    executing work the broker already abandoned (the reference ships
    timeoutMs in the InstanceRequest the same way).

    ``trace``/``trace_id``/``attempt``: the distributed-tracing stamp
    (the reference's InstanceRequest ``enableTrace`` + requestId): when
    the query runs with SET trace=true the broker sets traceEnabled on
    EVERY attempt — primary, retry, or hedge, ``attempt`` naming which —
    so the per-server span ladders all join one trace id.

    ``workload``/``priority``: the broker-resolved tenant and
    priority class — the server's weighted-fair scheduler groups slots
    by the TENANT (falling back to the table name when absent) so one
    tenant cannot hold every server slot, and the class weight sets the
    group's fair share."""
    return json.dumps(
        {
            "sql": sql,
            "segments": list(segments),
            "requestId": request_id,
            "brokerId": broker_id,
            "traceEnabled": trace,
            "traceId": trace_id,
            "attempt": attempt,
            "table": table,
            "timeFilter": time_filter,
            "timeoutMs": timeout_ms,
            "workload": workload,
            "priority": priority,
        }
    ).encode("utf-8")


def parse_instance_request(data: bytes) -> dict:
    return json.loads(data.decode("utf-8"))


def _bytes_handler(grpc, submit_fn, submit_streaming_fn=None,
                   fetch_segment_fn=None, execute_stage_fn=None,
                   exchange_transfer_fn=None):
    """The generic raw-bytes handler over ``grpc``'s base class."""

    class _BytesHandler(grpc.GenericRpcHandler):
        def __init__(self, submit_fn: Callable[[bytes], bytes],
                     submit_streaming_fn: Optional[Callable] = None,
                     fetch_segment_fn: Optional[Callable] = None,
                     execute_stage_fn: Optional[Callable] = None,
                     exchange_transfer_fn: Optional[Callable] = None):
            self._submit = submit_fn
            self._submit_streaming = submit_streaming_fn
            self._fetch_segment = fetch_segment_fn
            self._execute_stage = execute_stage_fn
            self._exchange_transfer = exchange_transfer_fn

        def service(self, handler_call_details):
            if handler_call_details.method == SUBMIT_METHOD:
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: self._submit(req),
                    request_deserializer=None,
                    response_serializer=None,
                )
            if (handler_call_details.method == EXECUTE_STAGE_METHOD
                    and self._execute_stage is not None):
                # broker → server: run one worker's slice of distributed
                # stage 2 (scan, partition, ship, join, partial-aggregate)
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: self._execute_stage(req),
                    request_deserializer=None,
                    response_serializer=None,
                )
            if (handler_call_details.method == EXCHANGE_TRANSFER_METHOD
                    and self._exchange_transfer is not None):
                # server → server: one hash-partition payload for a mailbox
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: self._exchange_transfer(req),
                    request_deserializer=None,
                    response_serializer=None,
                )
            if (handler_call_details.method == SUBMIT_STREAMING_METHOD
                    and self._submit_streaming is not None):
                # server-streaming: one DataTable block per yield
                # (server.proto:43-47 streaming Submit analog)
                return grpc.unary_stream_rpc_method_handler(
                    lambda req, ctx: self._submit_streaming(req),
                    request_deserializer=None,
                    response_serializer=None,
                )
            if (handler_call_details.method == FETCH_SEGMENT_METHOD
                    and self._fetch_segment is not None):
                # server-streaming tar chunks of a hosted segment dir
                return grpc.unary_stream_rpc_method_handler(
                    lambda req, ctx: self._fetch_segment(req),
                    request_deserializer=None,
                    response_serializer=None,
                )
            return None

    return _BytesHandler(submit_fn, submit_streaming_fn, fetch_segment_fn,
                         execute_stage_fn, exchange_transfer_fn)

class QueryServerTransport:
    """Server side: listens and dispatches Submit to the handler."""

    def __init__(self, submit_fn: Callable[[bytes], bytes],
                 host: str = "127.0.0.1", port: int = 0, max_workers: int = 8,
                 submit_streaming_fn: Optional[Callable] = None, tls=None,
                 fetch_segment_fn: Optional[Callable] = None,
                 execute_stage_fn: Optional[Callable] = None,
                 exchange_transfer_fn: Optional[Callable] = None):
        import grpc

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            handlers=(_bytes_handler(grpc, submit_fn, submit_streaming_fn,
                                     fetch_segment_fn, execute_stage_fn,
                                     exchange_transfer_fn),),
            options=_SIZE_OPTIONS,
        )
        if tls is not None:
            # TlsConfig (common/tls.py) — the reference's Netty/gRPC TLS
            # listener (TlsConfig.java + GrpcQueryServer secure mode)
            self.port = self._server.add_secure_port(
                f"{host}:{port}", tls.server_credentials())
        else:
            self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host
        self.tls_enabled = tls is not None

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace)

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"


class QueryRouterChannel:
    """Broker side: one channel per server instance
    (transport/QueryRouter.java + ServerChannels analog)."""

    def __init__(self, endpoint: str, tls=None):
        import grpc

        self.endpoint = endpoint
        if tls is not None:
            self._channel = grpc.secure_channel(
                endpoint, tls.channel_credentials(),
                options=tuple(tls.channel_options()) + _SIZE_OPTIONS)
        else:
            self._channel = grpc.insecure_channel(
                endpoint, options=_SIZE_OPTIONS)
        self._submit = self._channel.unary_unary(
            SUBMIT_METHOD, request_serializer=None, response_deserializer=None
        )
        self._submit_streaming = self._channel.unary_stream(
            SUBMIT_STREAMING_METHOD, request_serializer=None,
            response_deserializer=None,
        )
        self._fetch_segment = self._channel.unary_stream(
            FETCH_SEGMENT_METHOD, request_serializer=None,
            response_deserializer=None,
        )
        self._execute_stage = self._channel.unary_unary(
            EXECUTE_STAGE_METHOD, request_serializer=None,
            response_deserializer=None,
        )
        self._exchange_transfer = self._channel.unary_unary(
            EXCHANGE_TRANSFER_METHOD, request_serializer=None,
            response_deserializer=None,
        )

    def submit(self, request: bytes, timeout_s: float) -> bytes:
        return self._submit(request, timeout=timeout_s)

    def execute_stage(self, request: bytes, timeout_s: float) -> bytes:
        """Distributed stage-2: DataTable of the worker's merged
        partition partials."""
        return self._execute_stage(request, timeout=timeout_s)

    def transfer(self, request: bytes, timeout_s: float) -> bytes:
        """Exchange payload → JSON ack {ok, spilled, softLimit}."""
        return self._exchange_transfer(request, timeout=timeout_s)

    def fetch_segment(self, request: bytes, timeout_s: float):
        """Peer segment download: iterator of tar chunks."""
        return self._fetch_segment(request, timeout=timeout_s)

    def submit_streaming(self, request: bytes, timeout_s: float):
        """Returns the gRPC response iterator (also a Call: the consumer
        may ``.cancel()`` it for early termination once it has enough
        rows — the streaming reduce's short-circuit)."""
        return self._submit_streaming(request, timeout=timeout_s)

    def close(self) -> None:
        self._channel.close()
