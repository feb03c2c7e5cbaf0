"""Super-step coordination for the sharded single-job engine.

The coordinator is the control plane of one sharded job: it lives in the
ROUTER process (leader-only — fleet/router.py runs it behind the leader's
flock lease, so a failed-over router never drives two copies of one job)
and replays the sparse engine's convention loops (_run_c/_run_cuda)
verbatim, with one twist: the per-generation step is a fleet-wide
super-step barrier instead of a local ``_step`` call.

Per super-step k, every worker — concurrently, one RPC each — sends its
boundary rings to its halo peers, blocks until every peer's frame for k
arrived, and advances its owned tiles through the exact solo kernel path.
The coordinator aggregates ``changed_any`` (OR) and the live-tile count
(sum) and feeds them into the SAME accounting the solo engine pins:
generation numbering, similarity counters, and all three exit reasons are
derived from the super-step count alone, so a sharded run's
(cells, generations, exit_reason) triple is byte-identical to one
worker's — the property the shard tests gate at N in {2, 3}.

Fault model: every ``checkpoint_every`` super-steps, all workers journal
their slice to their OWN partition's shard log and the coordinator
advances its durable floor only after EVERY ack. A SIGKILLed worker is
respawned by the fleet on the same partition; recovery restores it from
its own log at the floor (ONLY its shard replays), rewinds the survivors
in memory, and re-runs from the floor — super-steps are deterministic, so
the replayed timeline is the abandoned one, byte for byte.

Membership is elastic at checkpoint barriers: the HRW partition means a
grown worker set moves only the tiles the new worker wins (shard/
partition.moved_tiles), shipped as packed tile frames by their previous
owners.

This module runs in the router front-end and touches no device; its
``LocalCluster`` substrate imports the shard worker, whose sparse engine
and tile memo import torch (the JAX package's import no JAX until a tile
steps).
"""

from __future__ import annotations

import threading
import time
import urllib.error
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait

from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.fleet import client
from gol_tpu_torch.shard.partition import Partition
from gol_tpu_torch.shard.worker import PeerUnreachable, ShardHost
from gol_tpu_torch.sparse.board import SparseBoard
from gol_tpu_torch.sparse.engine import EXIT_EMPTY, EXIT_GEN_LIMIT, EXIT_SIMILAR

DEFAULT_CHECKPOINT_EVERY = 8
RECOVER_TIMEOUT = 120.0
PROBE_INTERVAL = 0.25


class ShardPeerDown(RuntimeError):
    """A worker did not answer (connection-level, 503, or barrier abort):
    the coordinator's cue to run recovery from the durable floor."""

    def __init__(self, worker_id: str, detail: str):
        super().__init__(f"shard worker {worker_id} down: {detail}")
        self.worker_id = worker_id


class ShardProtocolError(RuntimeError):
    """A worker answered with a non-retryable rejection (HTTP 4xx that is
    not a recovery abort): the job fails rather than retries."""


class LocalParticipant:
    """A worker reached by direct method call — the in-process test and
    LocalCluster substrate. Same surface as HttpParticipant.

    ``host_getter`` is consulted on EVERY call (mirroring the URL lookup
    of the HTTP path): a killed host resolves to None — ShardPeerDown —
    until its respawn installs a fresh one on the same journal dir."""

    def __init__(self, worker_id: str, host_getter):
        self.id = worker_id
        if isinstance(host_getter, ShardHost):
            host = host_getter
            host_getter = lambda: host  # noqa: E731 — fixed-host shorthand
        self._host_getter = host_getter
        self.job = None  # set by the coordinator at init

    def url(self) -> str:
        return f"local://{self.id}"

    def _host(self) -> ShardHost:
        host = self._host_getter()
        if host is None:
            raise ShardPeerDown(self.id, "process is down")
        return host

    def _guard(self, fn, *args):
        try:
            return fn(*args)
        except PeerUnreachable as e:
            raise ShardPeerDown(e.peer, str(e)) from e
        except ValueError as e:
            if "aborted for recovery" in str(e):
                raise ShardPeerDown(self.id, str(e)) from e
            raise ShardProtocolError(f"worker {self.id}: {e}") from e

    def init(self, payload: dict) -> dict:
        return self._guard(self._host().init_job, payload)

    def step(self, k: int) -> dict:
        return self._guard(self._host().step_job, self.job, k)

    def checkpoint(self, k: int) -> dict:
        return self._guard(self._host().checkpoint, self.job, k)

    def rewind(self, k: int, peers: dict) -> dict:
        return self._guard(self._host().rewind, self.job, k, peers)

    def restore(self, payload: dict) -> dict:
        return self._guard(self._host().restore_job, payload)

    def status(self) -> dict:
        return self._guard(self._host().status, self.job)

    def rebalance(self, payload: dict) -> dict:
        return self._guard(self._host().rebalance, payload)

    def collect(self, which: str) -> dict:
        return self._guard(self._host().collect, self.job, which)

    def finish(self) -> dict:
        return self._guard(self._host().finish, self.job)


class HttpParticipant:
    """A worker reached over HTTP through fleet/client.py — breakers,
    deadline budgets, and the chaos proxy apply exactly as they do to the
    serve tier's forward hop.

    ``url_getter`` is consulted on EVERY call: a respawned worker answers
    on a new port, and the fleet's membership record is the source of
    truth for where a partition currently lives."""

    def __init__(self, worker_id: str, url_getter, http=client.http_json):
        self.id = worker_id
        self._url_getter = url_getter
        self._http = http
        self.job = None  # set by the coordinator at init

    def url(self) -> str:
        url = self._url_getter()
        if not url:
            raise ShardPeerDown(self.id, "no URL on record (respawning?)")
        return url

    def _post(self, path: str, payload: dict, timeout: float = 120.0):
        url = self.url().rstrip("/") + "/shard/" + path
        try:
            status, body = self._http("POST", url, payload, timeout=timeout)
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise ShardPeerDown(self.id, f"{type(e).__name__}: {e}") from e
        if status == 503:
            raise ShardPeerDown(self.id, str(body)[:200])
        if status >= 400:
            detail = body.get("error", body) if isinstance(body, dict) \
                else body
            if "aborted for recovery" in str(detail):
                # Our own rewind interrupted this step's barrier: the
                # straggler RPC resolving during recovery, not a failure.
                raise ShardPeerDown(self.id, "step aborted for recovery")
            raise ShardProtocolError(
                f"worker {self.id} rejected /shard/{path}: "
                f"HTTP {status} {str(detail)[:300]}"
            )
        return body

    def init(self, payload: dict) -> dict:
        return self._post("init", payload)

    def step(self, k: int) -> dict:
        return self._post("step", {"job": self.job, "step": k})

    def checkpoint(self, k: int) -> dict:
        return self._post("checkpoint", {"job": self.job, "step": k})

    def rewind(self, k: int, peers: dict) -> dict:
        return self._post("rewind",
                          {"job": self.job, "step": k, "peers": peers})

    def restore(self, payload: dict) -> dict:
        return self._post("restore", payload)

    def status(self) -> dict:
        return self._post("status", {"job": self.job}, timeout=10.0)

    def rebalance(self, payload: dict) -> dict:
        return self._post("rebalance", payload, timeout=300.0)

    def collect(self, which: str) -> dict:
        return self._post("collect", {"job": self.job, "which": which},
                          timeout=300.0)

    def finish(self) -> dict:
        return self._post("done", {"job": self.job})


class ShardCoordinator:
    """Drives one sharded job over a set of participants.

    ``spec`` is the job document: rle, x, y, width, height, tile, plus the
    GameConfig fields (convention, gen_limit, check_similarity,
    similarity_frequency). ``membership`` is an optional zero-arg callable
    returning the CURRENT eligible participant list; consulted at
    checkpoint barriers only — the autoscaler's grow-mid-job hook."""

    def __init__(self, job_id: str, spec: dict, participants,
                 *, checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
                 registry=None, membership=None,
                 recover_timeout: float = RECOVER_TIMEOUT,
                 probe_interval: float = PROBE_INTERVAL):
        if not participants:
            raise ValueError("a sharded job needs at least one worker")
        self.job_id = job_id
        self.spec = dict(spec)
        self.config = GameConfig(
            gen_limit=int(spec.get("gen_limit", GameConfig.gen_limit)),
            check_similarity=bool(spec.get(
                "check_similarity", GameConfig.check_similarity)),
            similarity_frequency=int(spec.get(
                "similarity_frequency", GameConfig.similarity_frequency)),
            convention=spec.get("convention", Convention.C),
        )
        self.participants = list(participants)
        for p in self.participants:
            p.job = job_id
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.registry = registry
        self.membership = membership
        self.recover_timeout = recover_timeout
        self.probe_interval = probe_interval
        self.k = 0  # completed super-steps
        self.durable = 0  # last super-step checkpointed by EVERY worker
        self.live = 0  # fleet-wide live-tile count
        self.supersteps = 0  # super-steps executed, replays included
        self.recoveries = 0
        self.rebalances = 0
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, len(self.participants) + 2),
            thread_name_prefix=f"gol-shard-{job_id[:8]}")

    # -- plumbing ----------------------------------------------------------

    def _obs(self, fn, *args):
        if self.registry is not None:
            getattr(self.registry, fn)(*args)

    def _ids(self):
        return [p.id for p in self.participants]

    def _peer_urls(self) -> dict:
        return {p.id: p.url() for p in self.participants}

    def _payload(self, p, *, blank: bool = False, step: int = 0) -> dict:
        body = {
            "job": self.job_id, "spec": self.spec, "self": p.id,
            "workers": self._ids(), "peers": self._peer_urls(),
        }
        if blank:
            body["blank"] = True
        if step:
            body["step"] = step
        return body

    def _all(self, fn_name, *args):
        """One RPC per participant, concurrently; replies in participant
        order. The first ShardPeerDown wins at once: a straggler still
        blocked on its halo barrier, waiting for a frame the dead worker
        never sent, is left to the recovery rewind, which aborts that
        barrier (its reply, "aborted for recovery", is read and dropped).
        The JAX package's coordinator waits for every straggler here, so
        its recovery can sit out the whole step RPC timeout first."""
        futures = [
            self._pool.submit(getattr(p, fn_name), *args)
            for p in self.participants
        ]
        pending = set(futures)
        while pending:
            _done, pending = wait(pending, return_when=FIRST_EXCEPTION)
            down = [f for f in futures if f not in pending
                    and isinstance(f.exception(), ShardPeerDown)]
            if down:
                for fut in pending:
                    fut.add_done_callback(lambda f: f.exception())
                raise down[0].exception()
        return [fut.result() for fut in futures]

    def _gauge_ownership(self, counts: dict) -> None:
        for wid, n in counts.items():
            self._obs("set_gauge", f"shard_tiles_owned_{wid}", n)

    # -- lifecycle ---------------------------------------------------------

    def _init(self) -> None:
        futures = [
            self._pool.submit(p.init, self._payload(p))
            for p in self.participants
        ]
        replies = [f.result() for f in futures]
        self.live = sum(r["live"] for r in replies)
        self._obs("inc", "shard_jobs_total")
        self._obs("set_gauge", "shard_workers", len(self.participants))

    def _step_all(self, k: int) -> tuple[bool, int]:
        t0 = time.perf_counter()
        replies = self._all("step", k)
        self._obs("observe", "shard_superstep_seconds",
                  time.perf_counter() - t0)
        self.supersteps += 1
        changed = any(r["changed"] for r in replies)
        live = sum(r["live"] for r in replies)
        return changed, live

    def _checkpoint_all(self, k: int) -> None:
        self._all("checkpoint", k)
        self.durable = k
        self._obs("set_gauge", "shard_durable_step", k)

    def _recover(self) -> None:
        """All workers back to the durable floor. A worker that lost its
        process restores from its own shard log (only ITS shard replays);
        survivors rewind in memory. Loops until the whole set answers —
        the fleet's health tick is respawning the dead partition
        meanwhile — then the run loop re-executes from the floor."""
        self.recoveries += 1
        self._obs("inc", "shard_recoveries_total")
        deadline = time.perf_counter() + self.recover_timeout
        while True:
            try:
                peers = self._peer_urls()
                replies = []
                for p in self.participants:
                    if p.status().get("known"):
                        replies.append(p.rewind(self.durable, peers))
                    else:
                        replies.append(p.restore(
                            self._payload(p, step=self.durable)))
                self.k = self.durable
                self.live = sum(r["live"] for r in replies)
                return
            except ShardPeerDown:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(self.probe_interval)

    def _maybe_rebalance(self) -> None:
        """At a checkpoint barrier (k == durable): adopt a changed worker
        set. Joiners init BLANK at the current step under the new
        partition; every old participant then pushes exactly its moved-out
        tiles to the new owners (HRW-minimal) and departing workers drop
        the job; finally the NEW set checkpoints so the floor covers the
        new ownership map."""
        if self.membership is None:
            return
        new = self.membership()
        if new is None:
            return
        new = list(new)
        if [p.id for p in new] == self._ids() or not new:
            return
        for p in new:
            p.job = self.job_id
        old = self.participants
        old_by_id = {p.id: p for p in old}
        new_ids = [p.id for p in new]
        peers = {p.id: p.url() for p in new}
        joiners = [p for p in new if p.id not in old_by_id]
        for p in joiners:
            body = self._payload(p, blank=True, step=self.k)
            body["workers"] = new_ids
            body["peers"] = peers
            p.init(body)
        moved = 0
        for p in old:
            reply = p.rebalance({
                "job": self.job_id, "workers": new_ids, "peers": peers,
                "step": self.k,
            })
            moved += int(reply.get("moved", 0))
        self.participants = [old_by_id.get(p.id, p) for p in new]
        self._checkpoint_all(self.k)
        self.rebalances += 1
        self._obs("inc", "shard_rebalances_total")
        self._obs("inc", "shard_rebalanced_tiles_total", moved)
        self._obs("set_gauge", "shard_workers", len(self.participants))

    def _barrier(self) -> None:
        """The periodic durability + elasticity point."""
        if self.k % self.checkpoint_every == 0:
            self._checkpoint_all(self.k)
            self._maybe_rebalance()

    # -- the run loop ------------------------------------------------------

    def run(self) -> dict:
        """Execute the job to completion; returns the result document.
        Convention accounting tracks engine._run_c/_run_cuda line for
        line, with ``generation`` derived from the super-step count so a
        recovery rewind re-derives the loop state exactly."""
        try:
            self._init()
            if self.config.convention == Convention.CUDA:
                return self._drive(self._loop_cuda)
            return self._drive(self._loop_c)
        finally:
            self._pool.shutdown(wait=False)

    def _drive(self, loop) -> dict:
        while True:
            try:
                return loop()
            except ShardPeerDown:
                self._recover()

    def _sim_counter(self) -> int:
        # The similarity counter is k mod frequency on any timeline that
        # reached k without a similar exit — what makes it re-derivable
        # after a rewind.
        return self.k % self.config.similarity_frequency

    def _loop_c(self) -> dict:
        cfg = self.config
        counter = self._sim_counter()
        # Loop-top invariant: generation == k + 1 (engine._run_c).
        while self.live > 0 and self.k < cfg.gen_limit:
            changed, live = self._step_all(self.k)
            self.k += 1
            if cfg.check_similarity:
                counter += 1
                if counter == cfg.similarity_frequency:
                    if not changed:
                        return self._finalize("current", self.k - 1,
                                              EXIT_SIMILAR)
                    counter = 0
            self.live = live
            self._barrier()
        reason = EXIT_GEN_LIMIT if self.live else EXIT_EMPTY
        return self._finalize("current", self.k, reason)

    def _loop_cuda(self) -> dict:
        cfg = self.config
        counter = self._sim_counter()
        # Loop-top invariant: generation == k (engine._run_cuda); the
        # breaks precede the swap, so both exits collect the PRE-step
        # board every worker kept as ``prev``.
        while self.k < cfg.gen_limit:
            changed, live = self._step_all(self.k)
            if cfg.check_similarity:
                counter += 1
                if counter == cfg.similarity_frequency:
                    if not changed:
                        return self._finalize("prev", self.k, EXIT_SIMILAR)
                    counter = 0
            if live == 0:
                return self._finalize("prev", self.k, EXIT_EMPTY)
            self.live = live
            self.k += 1
            self._barrier()
        return self._finalize("current", self.k, EXIT_GEN_LIMIT)

    # -- results -----------------------------------------------------------

    def _finish_one(self, p) -> None:
        """Once the merged board is in hand, a dropped finish ack must NOT
        escalate to recovery: the worker may have already appended its done
        record ("frame landed, ack lost"), and replaying the tail from the
        durable floor would finalize a second time — a duplicate done in
        the exactly-once audit. Retry this participant alone; the worker
        side is idempotent, so a resent finish lands as a no-op ack."""
        deadline = time.perf_counter() + self.recover_timeout
        while True:
            try:
                p.finish()
                return
            except ShardPeerDown:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(self.probe_interval)

    def _finalize(self, which: str, generations: int, reason: str) -> dict:
        replies = self._all("collect", which)
        height = int(self.spec["height"])
        width = int(self.spec["width"])
        tile = int(self.spec.get("tile") or 0)
        merged = SparseBoard(height, width, tile) if tile else \
            SparseBoard(height, width)
        stats = {"tiles_active": 0, "tiles_computed": 0, "memo_hits": 0}
        for reply in replies:
            part = SparseBoard.from_rle(
                reply["rle"], height=height, width=width,
                tile=merged.tile)
            for coord, arr in part.tiles.items():
                merged.set_tile(coord, arr)
            _gens, active, computed, hits = reply["stats"]
            stats["tiles_active"] += int(active)
            stats["tiles_computed"] += int(computed)
            stats["memo_hits"] += int(hits)
        partition = Partition(self._ids(), merged.tiles_y, merged.tiles_x)
        ownership = partition.counts(merged.tiles)
        self._gauge_ownership(ownership)
        for p in self.participants:
            self._finish_one(p)
        t = merged.tile
        return {
            "rle": merged.to_rle(),
            "generations": int(generations),
            "exit_reason": reason,
            "population": merged.population(),
            "live_tiles": len(merged.tiles),
            "tiles_active": stats["tiles_active"],
            "tiles_computed": stats["tiles_computed"],
            "memo_hits": stats["memo_hits"],
            "cell_updates": stats["tiles_active"] * t * t,
            "supersteps": self.supersteps,
            "recoveries": self.recoveries,
            "rebalances": self.rebalances,
            "workers": self._ids(),
            "ownership": ownership,
        }


class LocalCluster:
    """N in-process ShardHosts wired into one halo fabric over ``local://``
    URLs — the unit-test and doc-example substrate: every protocol leg
    (init, halo frames as real GOLP bytes, barriers, checkpoints, kill/
    restore) runs exactly as over HTTP, minus the sockets."""

    def __init__(self, worker_ids, journal_root: str | None = None,
                 fault=None):
        self.ids = [str(w) for w in worker_ids]
        self.fault = fault  # optional hook(url, raw) -> raises to inject
        self.hosts: dict[str, ShardHost | None] = {}
        self.journal_dirs: dict[str, str | None] = {}
        self._lock = threading.Lock()
        for wid in self.ids:
            jdir = f"{journal_root}/{wid}" if journal_root else None
            self.journal_dirs[wid] = jdir
            self.hosts[wid] = ShardHost(
                journal_dir=jdir, http_exchange=self._exchange)

    def _exchange(self, method, url, body=None, *, raw=None, timeout=30.0,
                  headers=None, content_type=None):
        """Loopback transport for worker->worker frames: routes
        ``local://<wid>/shard/<leg>`` to the target host in process."""
        assert url.startswith("local://"), url
        rest = url[len("local://"):]
        wid, _, path = rest.partition("/")
        if self.fault is not None:
            self.fault(url, raw)
        with self._lock:
            host = self.hosts.get(wid)
        if host is None:
            raise ConnectionError(f"worker {wid} is down")
        import json as _json
        try:
            if path == "shard/halo":
                reply = host.halo_in(raw)
            elif path == "shard/adopt":
                reply = host.adopt(raw)
            else:
                raise AssertionError(f"unexpected loopback leg {path}")
        except ValueError as e:
            return 400, "application/json", _json.dumps(
                {"error": str(e)}).encode()
        return 200, "application/json", _json.dumps(reply).encode()

    def participants(self, ids=None):
        return [
            LocalParticipant(wid, (lambda w=wid: self.hosts.get(w)))
            for wid in (ids or self.ids)
        ]

    def add(self, wid: str, journal_root: str | None = None) -> None:
        """Grow the cluster (the autoscaler analog): a fresh host the
        membership hook can hand to the coordinator as a joiner."""
        wid = str(wid)
        with self._lock:
            if wid in self.ids:
                raise ValueError(f"worker {wid} already exists")
            jdir = f"{journal_root}/{wid}" if journal_root else None
            self.ids.append(wid)
            self.journal_dirs[wid] = jdir
            self.hosts[wid] = ShardHost(
                journal_dir=jdir, http_exchange=self._exchange)

    def kill(self, wid: str) -> None:
        """SIGKILL analog: the host object (all in-memory state) is
        dropped; the shard log on disk survives."""
        with self._lock:
            self.hosts[wid] = None

    def respawn(self, wid: str) -> ShardHost:
        """A fresh process on the same journal partition."""
        with self._lock:
            host = ShardHost(journal_dir=self.journal_dirs[wid],
                             http_exchange=self._exchange)
            self.hosts[wid] = host
        return host
