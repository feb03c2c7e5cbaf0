"""Fleet membership: worker processes, the partitioned journal, health.

One ``Fleet`` owns N serving workers. A worker is either

- **local** — a ``gol serve`` subprocess this process spawned, bound to its
  own journal *partition* (``<fleet_dir>/<worker_id>/``). Local workers are
  supervised: a dead or unresponsive one is SIGKILLed (never leave two
  writers on one journal) and respawned on the SAME partition, whose
  replay-on-start finishes every accepted job exactly once; or
- **attached** — an externally managed ``gol serve`` reached by URL (the
  multi-host lane: boot workers wherever ``parallel/bootstrap.py`` put the
  devices, hand the router their URLs). Attached workers are health-checked
  and routed around, never respawned — their journals are theirs.

The **manifest** (``<fleet_dir>/manifest.json``, written atomically) is the
router-side membership record: every partition's id, journal subdir, last
URL, and pid. A restarted router reads it and *reattaches* — workers that
survived the router keep serving uninterrupted (probed live by URL), dead
local partitions are respawned and replay themselves. Fleet-wide
exactly-once needs nothing more: every job lives in exactly one partition,
and each partition's journal already guarantees exactly-once within it.

Health rides the obs/SLO surfaces: liveness is ``GET /healthz``,
burn-awareness is ``GET /slo`` — a worker whose SLO status is critical (or
actively shedding 429s) is marked ``backpressure`` and drained of NEW work
by the router's placement before clients ever see a 429.

Clocks: ``time.perf_counter`` only (the serve/obs wall-clock ban extends to
this package).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time

from gol_tpu_torch.fleet import client, lease

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
# Cross-process serialization of manifest writes (fleet/lease.py, the
# compaction.lock discipline): an attached second router, a respawning
# supervisor, and an offline `gol compact` may all hold Fleet objects on
# one fleet dir — the in-process _manifest_lock cannot see each other.
MANIFEST_LOCK = "manifest.lock"
# The leader lease: whoever flocks it runs the single-writer ticks
# (respawn supervision, autoscaling). SIGKILL-safe — the kernel releases
# it with the holder's last fd, and any survivor acquires it next tick.
LEADER_LOCK = "leader.lock"
_URL_RE = re.compile(rb"serving on (http://\S+)")
# The module every spawned worker and router replica runs (``python -m``).
WORKER_MODULE = "gol_tpu_torch"


def core_slice_prefix(width: int, ncores: int | None = None):
    """A ``Fleet(spawn_prefix=...)`` hook pinning worker k to its own
    equal ``taskset`` core slice (the fixed per-worker budget of a
    one-worker-per-device deployment, on a shared host).

    The slice index comes from the digits of the worker id, so a respawn
    keeps its slice and an autoscaled spawn lands on a distinct one. The
    modulo wraps slices once the host runs out of distinct cores — the
    CLI rejects ``width > cpu_count`` up front, because taskset fails
    outright on a range that names CPUs the host does not have. One
    definition shared by ``gol fleet --cores-per-worker`` and the bench
    fleet lanes: the bench must pin exactly like production."""
    if width < 1:
        raise ValueError(f"core slice width must be >= 1, got {width}")
    ncores = ncores or os.cpu_count() or width
    if width > ncores:
        raise ValueError(
            f"core slice width {width} exceeds the host's {ncores} cores"
        )

    def prefix(worker):
        index = int("".join(c for c in worker.id if c.isdigit()) or 0)
        lo = (index * width) % max(1, ncores - width + 1)
        return ["taskset", "-c", f"{lo}-{lo + width - 1}"]

    return prefix


@dataclasses.dataclass
class Worker:
    """One serving worker as the fleet sees it."""

    id: str
    url: str | None = None
    journal_dir: str | None = None  # partition dir; None for attached
    big: bool = False  # the oversized-board lane
    attached: bool = False  # by-URL: never spawned or respawned here
    proc: subprocess.Popen | None = None
    pid: int | None = None  # survives manifest round-trips (proc does not)
    log_path: str | None = None
    log_offset: int = 0  # where THIS boot's log starts (the log appends)
    healthy: bool = True
    backpressure: bool = False  # SLO-critical / shedding: no NEW work
    failures: int = 0  # consecutive failed liveness probes
    restarts: int = 0
    respawning: bool = False  # a background respawn is in flight
    retiring: bool = False  # autoscaler drain->retire in flight: no NEW work
    # Affinity weights (fleet/affinity.py): ``weight`` is the operator-
    # pinned capacity (e.g. the --cores-per-worker slice width, manifest-
    # persisted so routers agree across restarts); ``advertised_weight``
    # is what the worker's own /healthz reported (its tuned marginal
    # kernel rate) — adopted by the health loop, never persisted.
    weight: float | None = None
    advertised_weight: float | None = None
    # The worker's last GET /slo payload, stored by the health tick so
    # the autoscaler reads burn rates without a second probe fan-out.
    slo: dict | None = None

    def manifest_record(self) -> dict:
        return {
            "id": self.id,
            "url": self.url,
            "journal": (os.path.basename(self.journal_dir)
                        if self.journal_dir else None),
            "big": self.big,
            "attached": self.attached,
            "pid": self.pid,
            **({"weight": self.weight} if self.weight is not None else {}),
        }

    def public(self) -> dict:
        """What GET /fleet shows (and what tools/fleet_smoke.py kills by)."""
        return {
            "id": self.id,
            "url": self.url,
            "big": self.big,
            "attached": self.attached,
            "healthy": self.healthy,
            "backpressure": self.backpressure,
            "retiring": self.retiring,
            "pid": self.pid,
            "restarts": self.restarts,
            **({"weight": self.weight} if self.weight is not None else {}),
        }


class Fleet:
    """Membership + manifest + supervision for one set of workers."""

    def __init__(
        self,
        fleet_dir: str,
        serve_args: tuple | list = (),
        fail_after: int = 3,
        boot_timeout: float = 180.0,
        probe=client.probe,
        http=client.http_json,
        spawn_prefix=None,
        spawn_weight: float | None = None,
        replica: bool = False,
    ):
        self.fleet_dir = fleet_dir
        os.makedirs(fleet_dir, exist_ok=True)
        self.serve_args = list(serve_args)
        # Optional command prefix per worker (callable Worker -> [str]):
        # e.g. a `taskset -c` core slice so every worker gets an equal,
        # fixed resource budget on a shared host (the bench suite's
        # scale-out control; a real fleet gives each worker its own device).
        self._spawn_prefix = spawn_prefix
        # Default pinned affinity weight for local spawns (the
        # --cores-per-worker slice width): every spawned worker — incl.
        # autoscaled ones — carries it unless spawn() pins its own.
        self._spawn_weight = spawn_weight
        self.fail_after = fail_after
        self.boot_timeout = boot_timeout
        self._probe = probe
        self._http = http
        self._lock = threading.Lock()
        self._workers: dict[str, Worker] = {}
        self._health_thread: threading.Thread | None = None
        self._health_stop = threading.Event()
        self._respawns: dict[str, threading.Thread] = {}
        self._manifest_lock = threading.Lock()
        # Replica mode (`gol router`): this Fleet is a READ view of a
        # membership some other process owns — load() adopts without
        # respawning, the manifest is never written while following, and
        # supervision stays off until the leader lease is won. The data
        # plane (placement, forwards, probes) is identical either way:
        # HRW is deterministic, so every replica routes like the leader.
        self.replica = replica
        # Whether THIS process runs the single-writer ticks (respawn,
        # and — via the autoscaler's gate — scale decisions). Flips
        # False -> True exactly once, when the leader lease is won; a
        # live holder never loses it (flock releases only on death).
        self.supervise = not replica
        self._lease: lease.FlockLease | None = None
        # Optional fleet-level config block carried IN the manifest (the
        # serve args, router flags, and autoscale settings a replica
        # needs to take over as leader): set by the spawning CLI before
        # the first write, adopted by load()/reconcile on replicas —
        # membership AND configuration share one source of truth.
        self.manifest_config: dict | None = None
        # Per-tick hooks (the autoscaler's ride on the health loop): each
        # is called after the worker probes of every health tick, inside
        # the tick's own exception guard.
        self._tick_hooks: list = []

    # -- membership --------------------------------------------------------

    def workers(self) -> list[Worker]:
        with self._lock:
            return list(self._workers.values())

    def worker(self, worker_id: str) -> Worker | None:
        with self._lock:
            return self._workers.get(worker_id)

    def shard_pool(self) -> list[Worker]:
        """The workers eligible to HOLD a shard of a sharded single-job
        run (``shard/``): routable, healthy, not mid-drain. Stricter
        than the submit walk on purpose — a shard assignment is sticky
        for the whole job (its checkpoints live in the owner's journal
        partition), so a wobbling worker that a submit would merely
        deprioritize must not anchor a shard. Sorted by id: every caller
        derives the same membership list, and the HRW partition is a
        pure function of that list."""
        with self._lock:
            pool = [w for w in self._workers.values()
                    if w.url and w.healthy and not w.retiring
                    and not w.respawning]
        return sorted(pool, key=lambda w: w.id)

    def _add(self, worker: Worker) -> Worker:
        with self._lock:
            if worker.id in self._workers:
                raise ValueError(f"duplicate worker id {worker.id}")
            self._workers[worker.id] = worker
        self.write_manifest()
        return worker

    def _next_id(self, big: bool) -> str:
        with self._lock:
            prefix = "big" if big else "w"
            n = 0
            while f"{prefix}{n}" in self._workers:
                n += 1
            return f"{prefix}{n}"

    def attach(self, url: str, worker_id: str | None = None,
               big: bool = False, weight: float | None = None) -> Worker:
        """Adopt an externally managed worker by URL (multi-host lane).

        Idempotent on the URL: a restarted ``gol fleet`` passes the same
        ``--attach`` flags it was launched with AND recovers the same URLs
        from the manifest — re-adding would double-count the worker in
        membership, merged metrics, and round-robin sharding."""
        url = url.rstrip("/")
        with self._lock:
            for worker in self._workers.values():
                if worker.url == url:
                    return worker
        return self._add(Worker(
            id=worker_id or self._next_id(big),
            url=url,
            attached=True,
            big=big,
            weight=weight,
        ))

    def spawn(self, worker_id: str | None = None, big: bool = False,
              weight: float | None = None) -> Worker:
        """Spawn one local worker and wait until it serves.

        A boot that never becomes ready ROLLS BACK: the half-booted
        process is killed and the membership entry removed, so a failed
        autoscaler scale-up leaves no zombie for the health loop to
        respawn in a tight loop (the autoscaler's cooldown, not the
        supervisor, paces retries against a broken boot) and no phantom
        worker inflating the fleet's apparent capacity."""
        if weight is None:
            weight = self._spawn_weight
        worker = self._launch(Worker(id=worker_id or self._next_id(big),
                                     big=big, weight=weight))
        self._add(worker)
        try:
            self._await_ready(worker)
        except BaseException:
            if worker.proc is not None and worker.proc.poll() is None:
                worker.proc.kill()
                try:
                    worker.proc.wait(timeout=10)
                except (subprocess.TimeoutExpired, OSError):
                    pass
            with self._lock:
                self._workers.pop(worker.id, None)
            self.write_manifest()
            raise
        self.write_manifest()
        return worker

    def spawn_fleet(self, n_workers: int, big_lane: bool = False) -> None:
        """Bring the LOCAL worker count up to ``n_workers`` (+ the big lane),
        launching every missing process first and then waiting for all —
        boots overlap, so N workers cost one boot of wall clock."""
        launched = []
        with self._lock:
            locals_ = [w for w in self._workers.values()
                       if not w.attached and not w.big]
            have_big = any(w.big for w in self._workers.values())
        for _ in range(max(0, n_workers - len(locals_))):
            worker = self._launch(Worker(id=self._next_id(big=False),
                                         weight=self._spawn_weight))
            self._add(worker)
            launched.append(worker)
        if big_lane and not have_big:
            worker = self._launch(Worker(id=self._next_id(big=True), big=True,
                                         weight=self._spawn_weight))
            self._add(worker)
            launched.append(worker)
        for worker in launched:
            self._await_ready(worker)
        if launched:
            self.write_manifest()

    # -- local process management ------------------------------------------

    def _launch(self, worker: Worker) -> Worker:
        """Start the ``gol serve`` subprocess for one partition (does not
        wait for readiness — ``_await_ready`` does). The worker runs
        ``python -m gol_tpu_torch serve`` and inherits this process's
        environment (``GOL_TORCH_DEVICE=cpu`` included): without it the
        worker asks for the card, and one that finds none dies on boot,
        which ``_await_ready`` reports with the log's tail."""
        import gol_tpu_torch

        worker.journal_dir = worker.journal_dir or os.path.join(
            self.fleet_dir, worker.id
        )
        os.makedirs(worker.journal_dir, exist_ok=True)
        worker.log_path = worker.log_path or os.path.join(
            self.fleet_dir, f"{worker.id}.log"
        )
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(gol_tpu_torch.__file__)
        ))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        prefix = list(self._spawn_prefix(worker)) if self._spawn_prefix else []
        cmd = [
            *prefix,
            sys.executable, "-m", WORKER_MODULE, "serve",
            "--port", "0",
            "--journal-dir", worker.journal_dir,
            *self.serve_args,
        ]
        # Log to a file, not a pipe: nothing to drain, boots can overlap,
        # and the worker's logs survive it for post-mortems.
        with open(worker.log_path, "ab") as logf:
            logf.write(b"\n")  # boot boundary
            logf.flush()
            # Parse only THIS boot's output for the URL banner: the log
            # appends across respawns, and the previous boot's banner names
            # a port nobody listens on anymore.
            worker.log_offset = logf.tell()
            worker.proc = subprocess.Popen(
                cmd, env=env, stdout=logf, stderr=subprocess.STDOUT
            )
        worker.pid = worker.proc.pid
        worker.url = None  # learned from the boot banner
        logger.info("fleet: launched worker %s (pid %d) on partition %s",
                    worker.id, worker.pid, worker.journal_dir)
        return worker

    def _await_ready(self, worker: Worker) -> None:
        """Wait for the worker's ``serving on <url>`` banner, then for
        ``/healthz``. Raises RuntimeError (with a log tail) on a dead boot."""
        deadline = time.perf_counter() + self.boot_timeout
        while time.perf_counter() < deadline:
            if worker.proc is not None and worker.proc.poll() is not None:
                raise RuntimeError(
                    f"worker {worker.id} died on boot "
                    f"(rc={worker.proc.returncode}):\n{self._log_tail(worker)}"
                )
            if worker.url is None:
                matches = _URL_RE.findall(
                    self._read_log(worker)[worker.log_offset:]
                )
                if matches:
                    worker.url = matches[0].decode("ascii").rstrip("/")
            if worker.url is not None and self._probe(worker.url) is not None:
                worker.healthy = True
                worker.failures = 0
                return
            time.sleep(0.1)
        raise RuntimeError(
            f"worker {worker.id} did not become healthy within "
            f"{self.boot_timeout:.0f}s:\n{self._log_tail(worker)}"
        )

    def _read_log(self, worker: Worker) -> bytes:
        try:
            with open(worker.log_path, "rb") as f:
                return f.read()
        except OSError:
            return b""

    def _log_tail(self, worker: Worker, n: int = 3000) -> str:
        return self._read_log(worker)[-n:].decode("utf-8", "replace")

    @staticmethod
    def _looks_like_worker(pid: int) -> bool:
        """Whether the pid is (still) a process of this package (``python
        -m gol_tpu_torch``, matched as whole argv words: a JAX package
        worker, ``-m gol_tpu``, is not one of ours). Guards manifest-
        recovered pids against reuse: after a host reboot the partition's
        recorded pid may belong to a stranger, and 'never two journal
        writers' only requires the ORIGINAL worker dead — killing whatever
        now holds the number would be a supervision bug, not supervision."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            return False  # gone, or no /proc: never kill blind
        module = WORKER_MODULE.encode()
        return any(a == b"-m" and b == module
                   for a, b in zip(argv, argv[1:]))

    @classmethod
    def _ensure_dead(cls, pid: int | None, timeout: float = 10.0) -> None:
        """SIGKILL a (cmdline-verified) worker pid and wait for it to
        vanish. Called before EVERY respawn of an adopted partition: two
        live processes appending one partition's journal would weld records
        and break the exactly-once replay contract — an unresponsive-but-
        alive worker must die before its successor boots."""
        if pid is None or not cls._looks_like_worker(pid):
            return
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return
            time.sleep(0.05)
        logger.error("fleet: pid %d survived SIGKILL for %.0fs", pid, timeout)

    def _respawn(self, worker: Worker) -> None:
        if worker.proc is not None:
            # Our own child: the Popen handle cannot suffer pid reuse
            # (the zombie holds the pid until we reap it here).
            if worker.proc.poll() is None:
                worker.proc.kill()
            try:
                worker.proc.wait(timeout=10)
            except (subprocess.TimeoutExpired, OSError):
                pass
        else:
            # Adopted from the manifest: cmdline-verified kill.
            self._ensure_dead(worker.pid)
        worker.restarts += 1
        worker.healthy = False
        worker.backpressure = False
        worker.failures = 0
        logger.warning(
            "fleet: respawning worker %s on partition %s (restart #%d); "
            "its journal replays every unfinished job",
            worker.id, worker.journal_dir, worker.restarts,
        )
        try:
            self._launch(worker)
            self._await_ready(worker)
        except (RuntimeError, OSError) as err:
            logger.error("fleet: respawn of %s failed (%s); retrying on the "
                         "next health tick", worker.id, err)
            return
        self.write_manifest()

    def _respawn_async(self, worker: Worker) -> None:
        """Respawn off the health thread: ``_respawn`` blocks in
        ``_await_ready`` for up to ``boot_timeout``, and a tick stalled
        there would leave every OTHER worker unprobed — a second
        concurrent death (or a drain/shed recovery) unhandled for
        minutes. The ``respawning`` flag keeps later ticks off the worker
        until its respawn resolves (one respawner per partition: never
        two writers on one journal)."""
        if worker.respawning:
            return
        worker.respawning = True

        def run():
            try:
                # A shutdown that began after this thread was scheduled
                # must not boot a fresh worker terminate() never sees.
                if not self._health_stop.is_set():
                    self._respawn(worker)
            finally:
                worker.respawning = False

        thread = threading.Thread(
            target=run, name=f"gol-fleet-respawn-{worker.id}", daemon=True
        )
        with self._lock:
            self._respawns[worker.id] = thread
        thread.start()

    # -- manifest ----------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.fleet_dir, MANIFEST)

    def write_manifest(self) -> None:
        # Serialized end to end: concurrent background respawns (and the
        # health thread's banner adoption) share one .tmp path — two
        # interleaved truncate/write/replace sequences would publish a
        # garbled manifest and break the router-restart recovery lane.
        # The threading lock covers THIS process; the blocking flock on
        # manifest.lock covers every other one (a second router replica,
        # an offline tool) — both writers complete, strictly in turn, so
        # the .tmp stage can never interleave across processes either.
        if self.replica and not self.supervise:
            return  # a follower READS membership; only the leader writes
        with self._manifest_lock:
            with self._lock:
                doc = {
                    "version": 1,
                    **({"config": self.manifest_config}
                       if self.manifest_config else {}),
                    "partitions": [w.manifest_record()
                                   for w in self._workers.values()],
                }
            lock_fd = lease.acquire(
                os.path.join(self.fleet_dir, MANIFEST_LOCK), blocking=True
            )
            try:
                tmp = self.manifest_path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(doc, f, indent=1)
                    f.write("\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.manifest_path)
            finally:
                if lock_fd is not None:
                    lease.release(lock_fd)

    def load(self) -> int:
        """Reattach the fleet a previous router left behind (the router-
        restart lane). For every manifest partition: a worker answering at
        its recorded URL is adopted live (its jobs were never in danger);
        a dead LOCAL partition is respawned there and replays its journal;
        a dead attached worker is kept unhealthy and probed by the health
        loop until it returns. Returns the number of partitions recovered."""
        if not os.path.exists(self.manifest_path):
            return 0
        with open(self.manifest_path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc.get("config"), dict):
            self.manifest_config = doc["config"]
        n = 0
        for rec in doc.get("partitions", []):
            weight = rec.get("weight")
            worker = Worker(
                id=rec["id"],
                url=rec.get("url"),
                journal_dir=(os.path.join(self.fleet_dir, rec["journal"])
                             if rec.get("journal") else None),
                big=bool(rec.get("big")),
                attached=bool(rec.get("attached")),
                pid=rec.get("pid"),
                weight=float(weight) if weight else None,
            )
            alive = worker.url is not None and self._probe(worker.url) is not None
            if alive:
                logger.info("fleet: reattached live worker %s at %s",
                            worker.id, worker.url)
            elif worker.attached or self.replica:
                # A replica never respawns at boot — the partition is the
                # LEADER's to revive; adopt it unhealthy and keep probing
                # (exactly the dead-attached-worker posture). If this
                # replica later wins the lease, its supervised ticks take
                # over the respawn.
                worker.healthy = False
                logger.warning("fleet: %s worker %s unreachable at %s; "
                               "will keep probing",
                               "attached" if worker.attached else "adopted",
                               worker.id, worker.url)
            else:
                self._add(worker)
                self._respawn(worker)
                n += 1
                continue
            self._add(worker)
            n += 1
        return n

    def reconcile_from_manifest(self) -> int:
        """Follower-side membership sync: adopt what the leader's manifest
        says, without writing anything back. New partitions (a scale-up)
        appear, a respawned worker's fresh URL replaces the dead one, and
        partitions the leader retired (a scale-down) drop out — so every
        replica routes over the same membership the leader supervises,
        one tick behind at most. Returns the number of changes applied.

        Never touches a worker whose subprocess THIS fleet owns
        (``proc`` set): reconciliation is for adopted views only, and a
        follower never spawns."""
        try:
            with open(self.manifest_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0  # no manifest yet; writes are atomic, so never torn
        if isinstance(doc.get("config"), dict):
            self.manifest_config = doc["config"]
        recs = {rec["id"]: rec for rec in doc.get("partitions", [])
                if rec.get("id")}
        changed = 0
        with self._lock:
            for wid, rec in recs.items():
                url = rec.get("url")
                url = url.rstrip("/") if url else None
                worker = self._workers.get(wid)
                if worker is None:
                    weight = rec.get("weight")
                    self._workers[wid] = Worker(
                        id=wid,
                        url=url,
                        journal_dir=(
                            os.path.join(self.fleet_dir, rec["journal"])
                            if rec.get("journal") else None),
                        big=bool(rec.get("big")),
                        attached=bool(rec.get("attached")),
                        pid=rec.get("pid"),
                        weight=float(weight) if weight else None,
                        healthy=False,  # this tick's probe promotes it
                    )
                    changed += 1
                elif worker.proc is None:
                    if url is not None and worker.url != url:
                        # The leader respawned it: route to the new
                        # process once the probe (same tick) confirms it.
                        worker.url = url
                        worker.pid = rec.get("pid")
                        worker.failures = 0
                        worker.healthy = False
                        changed += 1
                    elif worker.pid != rec.get("pid"):
                        worker.pid = rec.get("pid")
                        changed += 1
            for wid in [w for w in self._workers if w not in recs]:
                worker = self._workers[wid]
                if (worker.proc is None and not worker.respawning
                        and not worker.retiring):
                    del self._workers[wid]  # the leader retired it
                    changed += 1
        if changed:
            logger.info("fleet: reconciled %d membership change(s) from "
                        "the manifest", changed)
        return changed

    # -- leader election ----------------------------------------------------

    def enable_leader_election(self, label: str = "") -> bool:
        """Arm the SIGKILL-safe leader lease on ``<fleet_dir>/leader.lock``
        and contest it once now; every later health tick re-contests.
        Returns whether this process leads right now. While not leading,
        ``supervise`` is False: no respawns, no manifest writes, and the
        autoscaler's tick no-ops — single-writer control with an
        active-active data plane."""
        if self._lease is None:
            self._lease = lease.FlockLease(
                os.path.join(self.fleet_dir, LEADER_LOCK), label=label
            )
        self.supervise = self._lease.try_acquire()
        return self.supervise

    @property
    def leading(self) -> bool:
        """Whether this process runs the single-writer ticks (True for a
        lease-holding or lease-less fleet — a plain one-router fleet
        supervises unconditionally, exactly as before elections existed)."""
        return self.supervise

    def _poll_leadership(self) -> None:
        if self._lease is None or self.supervise:
            return  # lease-less fleet, or already the holder (for life)
        if self._lease.try_acquire():
            self.supervise = True
            logger.warning(
                "fleet: leader lease acquired — this router now owns the "
                "single-writer ticks (respawn supervision, scale "
                "decisions); adopting membership from the manifest"
            )
            self.reconcile_from_manifest()

    def release_leadership(self) -> None:
        """Voluntary hand-off at shutdown so a survivor wins the lease
        without waiting for the kernel to reap this process."""
        if self._lease is not None:
            self._lease.release()
            if self.replica:
                self.supervise = False

    # -- health ------------------------------------------------------------

    def note_shed(self, worker_id: str) -> None:
        """The router observed this worker 429 a submit: stop routing new
        work there until the health loop sees its SLO recover."""
        worker = self.worker(worker_id)
        if worker is not None and not worker.backpressure:
            worker.backpressure = True
            logger.warning("fleet: worker %s is shedding; draining it of "
                           "new work", worker_id)

    def check_worker(self, worker: Worker) -> None:
        """One health tick for one worker: liveness via /healthz, burn via
        /slo, respawn for dead local processes."""
        if worker.respawning:
            return  # a background respawn owns this worker right now
        if worker.retiring:
            # The autoscaler's drain->retire thread owns this worker: no
            # respawn (a retiring worker dying mid-drain is the retire
            # thread's failure to handle), no backpressure churn.
            return
        if worker.proc is not None and worker.proc.poll() is not None:
            logger.warning("fleet: worker %s (pid %s) exited rc=%s",
                           worker.id, worker.pid, worker.proc.returncode)
            if self.supervise:
                self._respawn_async(worker)
            return
        if worker.url is None:
            if worker.proc is None:
                # Adopted from a manifest written mid-boot (the previous
                # supervisor died between launch and banner): there is no
                # log offset to scan — only the leader may relaunch the
                # partition (its _respawn kills any half-booted orphan
                # first; never two journal writers).
                if self.supervise and not worker.attached:
                    self._respawn_async(worker)
                return
            # A boot that outlived _await_ready's patience (e.g.
            # --warm-plans compiling on a loaded host) but whose process is
            # alive: keep looking for its banner every tick — otherwise the
            # worker serves forever on a port the router never learns and
            # its partition is stranded.
            if worker.proc.poll() is not None:
                return
            matches = _URL_RE.findall(
                self._read_log(worker)[worker.log_offset:]
            )
            if not matches:
                return
            worker.url = matches[0].decode("ascii").rstrip("/")
            self.write_manifest()
        hz = self._probe(worker.url)
        if hz is None:
            worker.failures += 1
            if worker.failures >= self.fail_after:
                if worker.healthy:
                    logger.warning(
                        "fleet: worker %s failed %d consecutive liveness "
                        "probes; routing around it", worker.id, worker.failures,
                    )
                worker.healthy = False
                if not worker.attached and self.supervise:
                    self._respawn_async(worker)
            return
        worker.failures = 0
        worker.healthy = True
        if worker.weight is None and isinstance(hz, dict):
            # Affinity (fleet/affinity.py): a worker with no operator-
            # pinned weight may advertise its measured capacity on
            # /healthz (the tuned marginal kernel rate of its own plan
            # cache). Adopted, not persisted — it re-advertises per boot.
            advertised = hz.get("weight")
            if isinstance(advertised, (int, float)) and advertised > 0:
                worker.advertised_weight = float(advertised)
        slo = self._probe(worker.url, "/slo")
        worker.slo = slo  # the autoscaler's burn signal: one probe per tick
        if slo is not None:
            burning = (
                slo.get("status") == "critical"
                or bool((slo.get("shed") or {}).get("active"))
            )
            if burning and not worker.backpressure:
                logger.warning("fleet: worker %s SLO burn is critical; "
                               "draining it of new work", worker.id)
            if worker.backpressure and not burning:
                logger.info("fleet: worker %s recovered; routing to it again",
                            worker.id)
            worker.backpressure = burning

    def health_tick(self) -> None:
        # Leadership first: a survivor must claim the dead leader's lease
        # on THIS tick (the takeover latency the zero-SPOF story promises
        # is one health interval), then probe with its new authority.
        self._poll_leadership()
        if not self.supervise:
            # Followers track the leader's membership instead of writing
            # their own: the manifest is the single source of truth.
            self.reconcile_from_manifest()
        for worker in self.workers():
            self.check_worker(worker)
        for hook in list(self._tick_hooks):
            hook()

    def add_tick_hook(self, hook) -> None:
        """Ride the health loop: ``hook()`` runs after every tick's worker
        probes (the autoscaler's cadence), under the loop's exception
        guard — a raising hook costs one tick, never the loop."""
        self._tick_hooks.append(hook)

    def start_health(self, interval: float = 1.0) -> None:
        if self._health_thread is not None:
            return
        self._health_stop.clear()

        def loop():
            while not self._health_stop.wait(interval):
                try:
                    self.health_tick()
                except Exception:  # noqa: BLE001 - supervision must survive
                    logger.exception("fleet: health tick failed")

        self._health_thread = threading.Thread(
            target=loop, name="gol-fleet-health", daemon=True
        )
        self._health_thread.start()

    def stop_health(self) -> None:
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=self.boot_timeout + 15)
            self._health_thread = None
        # In-flight background respawns must resolve before terminate():
        # a worker launched after the kill sweep would outlive the fleet.
        with self._lock:
            respawns = list(self._respawns.values())
            self._respawns.clear()
        for thread in respawns:
            thread.join(timeout=self.boot_timeout + 15)

    # -- scale-down: drain -> retire ---------------------------------------

    def retire(self, worker_id: str, drain_timeout: float = 600.0) -> bool:
        """Retire one LOCAL worker: cascade drain -> stop -> remove.

        The scale-down actuator (fleet/autoscale.py). Ordering is the
        whole contract:

        1. mark ``retiring`` — the router stops routing NEW work there
           (and the health loop stops supervising it) immediately;
        2. ``POST /drain`` — the worker finishes every accepted job and
           journals its done records; a drain that fails or times out
           ABORTS the retire (losing capacity must never risk losing
           jobs). A drain may have REACHED the worker before failing
           here, and a draining scheduler 429s new work forever — so the
           abort path restores the worker via the supervised respawn on
           its own partition (journal replay finishes anything the
           partial drain left; exactly-once holds as for any crash)
           rather than pretending the old process still serves;
        3. stop the process (SIGTERM first — it already drained, so this
           is quick — SIGKILL past ``timeout``) and remove the worker
           from membership + manifest.

        The journal partition STAYS on disk, fully drained: every job it
        ever accepted has a done record, and the next scale-up reuses the
        lowest free worker id — landing on this same partition, whose
        replay finds only terminal records. Retired capacity is never an
        orphaned journal. Attached workers are not ours to retire."""
        worker = self.worker(worker_id)
        if worker is None or worker.attached or worker.big:
            return False
        if worker.retiring or worker.respawning:
            return False
        worker.retiring = True
        drained = False
        if worker.url is not None:
            try:
                status, payload = self._http(
                    "POST", worker.url + "/drain", body={},
                    timeout=drain_timeout,
                )
                drained = status == 200 and bool(
                    isinstance(payload, dict) and payload.get("drained")
                )
            except (OSError, ValueError) as err:
                logger.error("fleet: drain of retiring worker %s failed "
                             "(%s)", worker_id, err)
        if not drained:
            # The drain may have landed (its scheduler then refuses new
            # work forever — there is no un-drain), so "keep serving" is
            # not an option: respawn on the same partition. The replay
            # finishes whatever the partial drain left, and the fresh
            # process admits work again.
            logger.error("fleet: worker %s did not drain; ABORTING its "
                         "retire and respawning it on its partition "
                         "(journal replays; a possibly-draining process "
                         "cannot be returned to service)", worker_id)
            try:
                self._respawn(worker)
            finally:
                worker.retiring = False
            return False
        if worker.proc is not None:
            if worker.proc.poll() is None:
                worker.proc.terminate()
                try:
                    worker.proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    worker.proc.kill()
                    try:
                        worker.proc.wait(timeout=10)
                    except (subprocess.TimeoutExpired, OSError):
                        pass
        elif worker.pid is not None and self._looks_like_worker(worker.pid):
            try:
                os.kill(worker.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            self._ensure_dead(worker.pid)
        with self._lock:
            self._workers.pop(worker_id, None)
        self.write_manifest()
        logger.warning("fleet: retired worker %s (partition %s drained; "
                       "its journal holds only terminal records)",
                       worker_id, worker.journal_dir)
        return True

    # -- fleet-wide drain / shutdown ---------------------------------------

    def drain_all(self, timeout: float = 600.0) -> dict:
        """Cascade POST /drain to every worker concurrently; returns
        {worker_id: {"drained": bool, ...}} when all are quiescent (or
        unreachable)."""
        results: dict[str, dict] = {}
        lock = threading.Lock()

        def drain_one(worker: Worker):
            out = {"drained": False}
            if worker.url is not None:
                try:
                    status, payload = self._http(
                        "POST", worker.url + "/drain", body={},
                        timeout=timeout,
                    )
                    if status == 200 and isinstance(payload, dict):
                        out = payload
                    else:
                        out = {"drained": False, "status": status}
                except (OSError, ValueError) as err:
                    out = {"drained": False, "error": str(err)}
            with lock:
                results[worker.id] = out

        threads = [
            threading.Thread(target=drain_one, args=(w,), daemon=True)
            for w in self.workers()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 10)
        return results

    def terminate(self, timeout: float = 30.0) -> None:
        """SIGTERM every LOCAL worker (their own graceful-drain path) and
        wait; escalate to SIGKILL past the timeout. Attached workers are
        not ours to stop."""
        victims = [w for w in self.workers() if not w.attached]
        for worker in victims:
            if worker.proc is not None:
                if worker.proc.poll() is None:
                    worker.proc.terminate()
            elif worker.pid is not None and self._looks_like_worker(worker.pid):
                try:
                    os.kill(worker.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
        deadline = time.perf_counter() + timeout
        for worker in victims:
            if worker.proc is not None:
                try:
                    worker.proc.wait(
                        timeout=max(0.1, deadline - time.perf_counter())
                    )
                except subprocess.TimeoutExpired:
                    logger.error("fleet: worker %s ignored SIGTERM; killing",
                                 worker.id)
                    worker.proc.kill()
                    worker.proc.wait(timeout=10)
            elif worker.pid is not None:
                while time.perf_counter() < deadline:
                    try:
                        os.kill(worker.pid, 0)
                    except ProcessLookupError:
                        break
                    time.sleep(0.1)
                else:
                    self._ensure_dead(worker.pid)

    def stats(self) -> dict:
        workers = self.workers()
        return {
            "workers": len(workers),
            "healthy": sum(w.healthy for w in workers),
            "backpressured": sum(w.backpressure for w in workers),
            "retiring": sum(w.retiring for w in workers),
            "big_lane": any(w.big for w in workers),
            "restarts": sum(w.restarts for w in workers),
        }
