"""The in-process chaos proxy: one hostile network hop, on demand.

``ChaosProxy`` fronts one upstream HTTP endpoint (a ``gol serve`` worker,
a fleet router — any socket speaking the stack's HTTP) and injects the
faults a seeded ``ChaosPlan`` schedules, per exchange. It understands just
enough HTTP/1.1 to find message boundaries — header block plus a
``Content-Length`` body, which is all this stack ever sends — so faults
land at *meaningful* points: a reset after the request was delivered is a
genuinely ambiguous submit, a truncation tears a response that already
framed its length, a bit flip lands inside a ``GOLP`` frame's CRC-covered
words payload (the flip the frame's CRC gate must catch) or a JSON body's tail.

One proxy is one listening socket plus a thread per client connection;
``ProxyPool`` lazily mounts one proxy per distinct upstream URL (the
``gol fleet --chaos`` hook: the router resolves every data-path forward
through ``pool.url_for``, so worker respawns get fresh proxies
transparently). Faults are counted per kind in ``stats()`` — the chaos
matrix asserts the schedule actually fired, not merely that traffic
survived an idle proxy.

Health/supervision traffic stays OFF this path on purpose: the fleet's
health loop probes workers directly, so chaos exercises the data plane's
defenses (breakers, retries, deadlines, CRC gates) without also blinding
the supervisor that is part of those defenses.

Clocks: ``time.perf_counter``/``time.sleep`` only (test_lint's wall-clock
ban covers this package).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from urllib.parse import urlsplit

from gol_tpu_torch.chaos.plan import ChaosPlan, ChaosSchedule, FAULT_KINDS

logger = logging.getLogger(__name__)

_GOLP_HEADER = struct.Struct("<4sHHIII")  # magic..meta_len (CRC not needed)


def _read_http_message(rfile) -> tuple[bytes, bytes] | None:
    """One HTTP message (request or response) -> (head bytes incl. the
    blank line, body bytes by Content-Length), or None on a clean EOF
    before any byte. The stack always frames bodies with Content-Length
    (both handlers set it; urllib sets it on every POST), so no chunked
    support is needed — an unframed message reads as an empty body."""
    head = bytearray()
    while True:
        line = rfile.readline(65536)
        if not line:
            if not head:
                return None
            raise ConnectionError("peer closed mid-header")
        head += line
        if line in (b"\r\n", b"\n"):
            break
    length = 0
    for raw in bytes(head).split(b"\r\n"):
        name, _, value = raw.partition(b":")
        if name.strip().lower() == b"content-length":
            try:
                length = int(value.strip())
            except ValueError:
                length = 0
    body = rfile.read(length) if length else b""
    if length and len(body) != length:
        raise ConnectionError("peer closed mid-body")
    return bytes(head), body


def _flip_bit(body: bytes, draw: float) -> bytes:
    """Flip ONE bit of the payload region of ``body`` (position chosen by
    the schedule's deterministic ``draw``). A ``GOLP`` frame flips inside
    its words payload — the bytes the header CRC covers, so the flip is
    catchable by construction; anything else flips in the trailing half
    (a JSON body's cells/grid tail). Too-small bodies pass untouched."""
    start = len(body) // 2
    if body[:4] == b"GOLP" and len(body) >= _GOLP_HEADER.size:
        meta_len = _GOLP_HEADER.unpack(body[:_GOLP_HEADER.size])[5]
        payload_at = _GOLP_HEADER.size + 4 + meta_len  # + the CRC field
        if payload_at < len(body):
            start = payload_at
    span = len(body) - start
    if span <= 0:
        return body
    offset = start + min(span - 1, int(draw * span))
    bit = int(draw * span * 8) % 8
    out = bytearray(body)
    out[offset] ^= 1 << bit
    return bytes(out)


def _rst_close(sock: socket.socket) -> None:
    """Close with a pending RST instead of a FIN: the reset the plan's
    ``refuse``/``reset`` classes mean (SO_LINGER 0 aborts the connection)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ChaosProxy:
    """One faulty hop in front of one upstream ``host:port``."""

    def __init__(self, upstream: str, plan: ChaosPlan,
                 schedule: ChaosSchedule | None = None,
                 host: str = "127.0.0.1", timeout: float = 120.0):
        parts = urlsplit(upstream if "//" in upstream
                         else f"http://{upstream}")
        if not parts.hostname or not parts.port:
            raise ValueError(f"chaos proxy upstream {upstream!r} needs an "
                             "explicit host:port")
        self.upstream = (parts.hostname, parts.port)
        self.plan = plan
        self.schedule = schedule if schedule is not None else plan.schedule()
        self.timeout = timeout
        self._stats_lock = threading.Lock()
        self._stats = {kind: 0 for kind in FAULT_KINDS}
        self._stats["exchanges"] = 0
        self._closed = False
        self._listener = socket.create_server((host, 0))
        self._listener.settimeout(1.0)
        self._thread = threading.Thread(
            target=self._accept_loop, name="gol-chaos-proxy", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    @property
    def url(self) -> str:
        host = self._listener.getsockname()[0]
        return f"http://{host}:{self.port}"

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def _count(self, kind: str) -> None:
        with self._stats_lock:
            self._stats[kind] = self._stats.get(kind, 0) + 1

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        self._thread.join(timeout=5)

    # -- the data path ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._serve_client, args=(conn,),
                name="gol-chaos-conn", daemon=True,
            ).start()

    def _serve_client(self, client: socket.socket) -> None:
        client.settimeout(self.timeout)
        try:
            rfile = client.makefile("rb")
            while not self._closed:
                if not self._exchange(client, rfile):
                    return
        except (OSError, ConnectionError):
            pass  # a torn peer is business as usual here
        finally:
            try:
                client.close()
            except OSError:
                pass

    def _exchange(self, client: socket.socket, rfile) -> bool:
        """Relay one request/response pair, injecting this exchange's
        fault. Returns False when the connection is finished (EOF or a
        connection-terminating fault)."""
        try:
            probe = rfile.peek(1)
        except (OSError, ValueError):
            return False
        if not probe:
            return False  # clean keep-alive EOF: no exchange, no roll
        fault, bit_draw, flip_request = self.schedule.next_fault()
        self._count("exchanges")
        if fault == "refuse":
            # Before the request is consumed: it was never delivered.
            self._count(fault)
            _rst_close(client)
            return False
        msg = _read_http_message(rfile)
        if msg is None:
            return False
        req_head, req_body = msg
        if fault == "bitflip" and flip_request and req_body:
            self._count(fault)
            req_body = _flip_bit(req_body, bit_draw)
            fault = None  # the flip IS this exchange's fault
        up = socket.create_connection(self.upstream, timeout=self.timeout)
        try:
            up.sendall(req_head + req_body)
            up_file = up.makefile("rb")
            resp = _read_http_message(up_file)
            if resp is None:
                raise ConnectionError("upstream closed without a response")
            resp_head, resp_body = resp
        except (OSError, ConnectionError):
            # A real upstream failure (worker mid-respawn, say): surface
            # it as a reset, exactly what a lost backend looks like.
            up.close()
            _rst_close(client)
            return False
        up.close()
        return self._relay_response(client, resp_head, resp_body, fault,
                                    bit_draw)

    def _relay_response(self, client: socket.socket, head: bytes,
                        body: bytes, fault: str | None,
                        bit_draw: float) -> bool:
        if fault == "latency":
            self._count(fault)
            time.sleep(self.plan.latency_ms / 1000.0)
        elif fault == "reset":
            self._count(fault)
            client.sendall(head + body[: len(body) // 2])
            _rst_close(client)
            return False
        elif fault == "truncate":
            self._count(fault)
            client.sendall(head + body[: len(body) // 2])
            try:
                client.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            client.close()
            return False
        elif fault == "slowloris":
            self._count(fault)
            client.sendall(head)
            chunk = self.plan.slow_chunk
            for i in range(0, len(body), chunk):
                client.sendall(body[i:i + chunk])
                time.sleep(self.plan.slow_ms / 1000.0)
            return True
        elif fault == "bitflip":
            if body:
                self._count(fault)
                body = _flip_bit(body, bit_draw)
        client.sendall(head + body)
        return True


class ProxyPool:
    """Lazily one ``ChaosProxy`` per distinct upstream URL.

    The router's ``--chaos`` mount point: every data-path forward resolves
    its target through ``url_for``, so a worker that respawns on a new
    port transparently gets a new faulty hop. Schedules are salted by
    creation order — deterministic fault sequences per proxy even though
    ports differ run to run."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._proxies: dict[str, ChaosProxy] = {}
        self._created = 0  # monotonic salt: prune() must never reuse one
        self._closed = False

    def url_for(self, upstream_url: str) -> str:
        key = upstream_url.rstrip("/")
        with self._lock:
            if self._closed:
                return upstream_url
            proxy = self._proxies.get(key)
            if proxy is None:
                proxy = ChaosProxy(key, self.plan,
                                   schedule=self.plan.schedule(
                                       salt=self._created))
                self._created += 1
                self._proxies[key] = proxy
                logger.info("chaos: proxy %s fronts %s", proxy.url, key)
            return proxy.url

    def prune(self, live_upstreams) -> None:
        """Close proxies whose upstream is gone. A supervised respawn
        moves a worker to a fresh port and ``url_for`` mounts a fresh hop
        for it — without pruning, the DEAD port's listener socket and
        accept thread would idle forever (one leak per respawn, unbounded
        over an autoscaling soak). The fleet health tick calls this with
        the live membership URLs every cadence."""
        keep = {u.rstrip("/") for u in live_upstreams if u}
        with self._lock:
            if self._closed:
                return
            dead = [(key, proxy) for key, proxy in self._proxies.items()
                    if key not in keep]
            for key, _ in dead:
                del self._proxies[key]
        for key, proxy in dead:
            logger.info("chaos: pruned proxy for dead upstream %s", key)
            proxy.close()

    def proxies(self) -> dict[str, ChaosProxy]:
        with self._lock:
            return dict(self._proxies)

    def stats(self) -> dict:
        """Fault counts summed across every mounted proxy."""
        totals: dict[str, int] = {}
        for proxy in self.proxies().values():
            for kind, count in proxy.stats().items():
                totals[kind] = totals.get(kind, 0) + count
        return totals

    def close(self) -> None:
        with self._lock:
            self._closed = True
            proxies = list(self._proxies.values())
            self._proxies.clear()
        for proxy in proxies:
            proxy.close()


__all__ = ["ChaosProxy", "ProxyPool"]
