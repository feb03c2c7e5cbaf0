"""Worker-side engine of the sharded single-job lane.

A ``ShardHost`` lives inside each ``gol serve`` process (serve/server.py
mounts it under ``POST /shard/*``) and holds the per-job shard state: the
owned slice of the universe (a SparseBoard carrying ONLY the tiles this
worker wins under the HRW partition), the tile memo, and the super-step
counter. The protocol, driven by the router's coordinator lane:

- ``init``     — build the owned slice straight from the job's RLE via the
                 tile-filtered streaming path (SparseBoard.from_rle with
                 ``owned`` — a worker owning one slice of a 2^20-square
                 document never materializes the rest), and journal the
                 step-0 checkpoint.
- ``halo``     — a peer's ring frame for step k lands in the inbox
                 (idempotent on (step, sender): a retried frame carries
                 identical bytes, so re-delivery overwrites harmlessly —
                 the exactly-once-EFFECT rule of the halo hop).
- ``step``     — send this worker's boundary rings to every peer, block
                 until every peer's frame for this step arrived (safe on
                 the threading server: each worker steps on its own
                 handler thread), then advance the owned tiles one
                 generation through the exact solo kernel path
                 (engine.step_tiles: same memo, same batch ladder, same
                 compiled tile programs). The pre-step board is retained
                 one step — the CUDA convention's empty/similar exits
                 return it.
- ``checkpoint/rewind/restore`` — super-step checkpoints land in a
                 dedicated fsync'd append-log in this worker's journal
                 partition (``shard-<job>.jsonl``; deliberately NOT the
                 job journal — jobs.JobJournal treats unknown record kinds
                 as torn lines on replay). A SIGKILLed worker replays ONLY
                 its own shard from its own log; survivors rewind in
                 memory.
- ``rebalance/adopt`` — elastic membership change at a checkpoint
                 barrier: each worker ships exactly its moved-out tiles
                 (HRW-minimal) to their new owners as packed tile frames
                 and adopts the new partition.
- ``collect/finish`` — the owned slice out as RLE; the terminal ``done``
                 audit record.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.error

from gol_tpu_torch.fleet import client
from gol_tpu_torch.io import wire
from gol_tpu_torch.obs import registry as obs_registry
from gol_tpu_torch.shard import halo
from gol_tpu_torch.shard.partition import Partition
from gol_tpu_torch.sparse.board import DEFAULT_TILE, SparseBoard
from gol_tpu_torch.sparse.engine import SparseStats, step_tiles
from gol_tpu_torch.sparse.memo import TileMemo

# How long a super-step blocks for peer halo frames before giving up.
# Generous on purpose: the coordinator's barrier means a slow peer is
# usually a dead peer mid-respawn, and the coordinator aborts the step
# fleet-wide long before this fires — the timeout only prevents a handler
# thread from blocking forever when the coordinator itself died.
BARRIER_TIMEOUT = 300.0


class ShardError(ValueError):
    """A protocol-level client error (unknown job, wrong step, malformed
    frame): maps to HTTP 400."""


class PeerUnreachable(RuntimeError):
    """A halo send exhausted its retry budget: maps to HTTP 503 naming the
    peer, the coordinator's cue to run recovery."""

    def __init__(self, peer: str, detail: str):
        super().__init__(
            f"halo peer {peer} unreachable after retries: {detail}"
        )
        self.peer = peer


class _ShardJob:
    """One job's shard state on one worker."""

    def __init__(self, job, spec, self_id, part, peers, log_path):
        self.job = job
        self.spec = spec
        self.self_id = self_id
        self.partition = part
        self.owned = part.owns(self_id)
        self.peers = dict(peers)
        self.log_path = log_path
        self.board: SparseBoard | None = None
        self.prev: SparseBoard | None = None
        self.memo = TileMemo()
        self.stats = SparseStats()
        self.step = 0  # completed super-steps
        self.cond = threading.Condition()
        self.gate = threading.Lock()  # serializes step vs rewind
        self.abort = False  # set by rewind to unblock a stuck barrier
        self.inbox: dict[tuple[int, str], dict] = {}
        self.last_reply: dict | None = None
        self.ckpt_step = 0
        self.ckpt_board: SparseBoard | None = None
        self.ckpt_stats: tuple | None = None

    def stats_tuple(self):
        s = self.stats
        return (s.generations, s.tiles_active, s.tiles_computed, s.memo_hits)

    def load_stats(self, tup):
        (self.stats.generations, self.stats.tiles_active,
         self.stats.tiles_computed, self.stats.memo_hits) = (
            int(v) for v in tup)


def _board_from_spec(spec: dict, owned) -> SparseBoard:
    return SparseBoard.from_rle(
        spec["rle"],
        height=int(spec["height"]),
        width=int(spec["width"]),
        tile=int(spec.get("tile") or DEFAULT_TILE),
        x=int(spec.get("x", 0)),
        y=int(spec.get("y", 0)),
        owned=owned,
    )


class ShardHost:
    """All shard jobs resident on one worker process."""

    def __init__(self, journal_dir: str | None = None,
                 http_exchange=client.http_exchange,
                 send_retries: int = 4,
                 barrier_timeout: float = BARRIER_TIMEOUT):
        self.journal_dir = journal_dir
        self.http_exchange = http_exchange
        self.send_retries = send_retries
        self.barrier_timeout = barrier_timeout
        self.jobs: dict[str, _ShardJob] = {}
        self.finished: set[str] = set()
        self.lock = threading.Lock()

    # -- plumbing ----------------------------------------------------------

    def _get(self, job) -> _ShardJob:
        st = self.jobs.get(str(job))
        if st is None:
            raise ShardError(f"unknown shard job {job}")
        return st

    def _log_path(self, job: str) -> str | None:
        if self.journal_dir is None:
            return None
        return os.path.join(self.journal_dir, f"shard-{job}.jsonl")

    def _append(self, st: _ShardJob, record: dict) -> None:
        """Durable append to the shard log: the record is on disk (fsync)
        before the caller acks — a barrier the coordinator advances its
        durable floor on must survive a SIGKILL one instruction later."""
        if st.log_path is None:
            return
        os.makedirs(os.path.dirname(st.log_path), exist_ok=True)
        with open(st.log_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _scan_ckpt(self, log_path: str, step: int) -> dict | None:
        """The LAST checkpoint record for ``step`` in a shard log (replay
        tolerates torn tails exactly like the job journal: a partial final
        line is skipped, never fatal)."""
        found = None
        try:
            with open(log_path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail (SIGKILL mid-append)
                    if rec.get("kind") == "ckpt" \
                            and int(rec.get("step", -1)) == step:
                        found = rec
        except OSError:
            return None
        return found

    def _build(self, body: dict) -> _ShardJob:
        job = str(body["job"])
        spec = dict(body["spec"])
        required = ("width", "height") if body.get("blank") \
            else ("rle", "width", "height")
        for field in required:
            if field not in spec:
                raise ShardError(f"shard spec missing {field!r}")
        self_id = str(body["self"])
        workers = [str(w) for w in body["workers"]]
        if self_id not in workers:
            raise ShardError(f"self {self_id!r} not in workers {workers}")
        tile = int(spec.get("tile") or DEFAULT_TILE)
        spec["tile"] = tile
        part = Partition.for_universe(
            workers, int(spec["height"]), int(spec["width"]), tile)
        peers = {str(k): str(v) for k, v in (body.get("peers") or {}).items()
                 if str(k) != self_id}
        return _ShardJob(job, spec, self_id, part, peers,
                         self._log_path(job))

    # -- protocol ----------------------------------------------------------

    def init_job(self, body: dict) -> dict:
        """POST /shard/init: build the owned slice, journal checkpoint 0.

        With ``"blank": true`` the slice starts EMPTY at super-step
        ``body["step"]`` — the elastic-join path: a worker added mid-job
        owns tiles under the new partition but receives their contents
        from the previous owners' rebalance pushes, never from the
        step-0 document."""
        st = self._build(body)
        if st.job in self.jobs:
            # Idempotent re-init (a coordinator retry after a lost ack):
            # same spec, same answer.
            return self._init_reply(self.jobs[st.job])
        if body.get("blank"):
            st.board = SparseBoard(int(st.spec["height"]),
                                   int(st.spec["width"]),
                                   int(st.spec["tile"]))
            st.step = int(body.get("step", 0))
        else:
            st.board = _board_from_spec(st.spec, st.owned)
        st.ckpt_step = st.step
        st.ckpt_board = st.board
        st.ckpt_stats = st.stats_tuple()
        self._append(st, {
            "kind": "ckpt", "job": st.job, "step": st.step,
            "rle": st.board.to_rle(), "stats": st.stats_tuple(),
        })
        with self.lock:
            self.jobs[st.job] = st
        obs_registry.default().inc("shard_jobs_hosted_total")
        return self._init_reply(st)

    def _init_reply(self, st: _ShardJob) -> dict:
        return {"job": st.job, "step": st.step,
                "live": len(st.board.tiles),
                "population": st.board.population()}

    def halo_in(self, raw: bytes) -> dict:
        """POST /shard/halo (packed): a peer's rings for one step."""
        meta, rings = halo.decode(raw)
        st = self._get(meta["job"])
        key = (int(meta["step"]), str(meta["from"]))
        with st.cond:
            st.inbox[key] = rings
            st.cond.notify_all()
        reg = obs_registry.default()
        reg.inc("shard_halo_frames_total")
        reg.inc("shard_halo_bytes_total", len(raw))
        return {"job": st.job, "step": key[0], "tiles": len(rings)}

    def _send_halo(self, st: _ShardJob, peer: str, raw: bytes) -> None:
        """One peer's frame out, with a bounded resend budget. A CRC 400
        from the receiver (the chaos proxy corrupting mid-frame) resends
        the same bytes; receiver-side idempotency on (step, sender) makes
        the retry exactly-once in effect."""
        url = st.peers[peer].rstrip("/") + "/shard/halo"
        detail = "no attempt"
        for attempt in range(self.send_retries):
            if attempt:
                time.sleep(0.05 * attempt)
            try:
                status, _ctype, body = self.http_exchange(
                    "POST", url, raw=raw, timeout=30,
                    content_type=wire.CONTENT_TYPE,
                )
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                detail = f"{type(e).__name__}: {e}"
                continue
            if status in (200, 202):
                return
            payload = body.decode("utf-8", "replace")[:200]
            if status == 400 and wire.is_crc_error(payload):
                # Torn/corrupted in flight: same bytes again.
                detail = f"crc reject: {payload}"
                continue
            if status in (400, 404) and "unknown shard job" in payload:
                # A freshly-respawned peer that has not been restored
                # yet: not-ready, not a protocol error — the coordinator
                # recovers the whole step from the durable floor.
                raise PeerUnreachable(peer, f"job not restored: {payload}")
            raise ShardError(
                f"halo peer {peer} rejected frame: HTTP {status} {payload}"
            )
        raise PeerUnreachable(peer, detail)

    def step_job(self, job, step, timeout: float | None = None) -> dict:
        """POST /shard/step: one super-step of the owned tiles.

        Holds the job's gate end to end (rewind serializes behind it) but
        the halo barrier wait is ABORTABLE: a concurrent rewind sets
        ``abort`` and wakes the condition, so a step stuck waiting on a
        SIGKILLed peer's frame fails fast instead of pinning recovery to
        the barrier timeout."""
        st = self._get(job)
        step = int(step)
        with st.gate:
            if step == st.step - 1 and st.last_reply is not None:
                return st.last_reply  # coordinator retry after a lost ack
            if step != st.step:
                raise ShardError(
                    f"shard job {st.job} is at super-step {st.step}, "
                    f"asked to run {step}"
                )
            peers = sorted(st.peers)
            out = halo.outgoing(st.board, st.partition, st.self_id)
            reg = obs_registry.default()
            for peer in peers:
                raw = halo.encode(st.job, step, st.self_id,
                                  out.get(peer) or {}, st.board.tile)
                self._send_halo(st, peer, raw)
                reg.inc("shard_halo_bytes_total", len(raw))
            ghost: dict = {}
            deadline = time.perf_counter() + (timeout or
                                              self.barrier_timeout)
            with st.cond:
                while True:
                    if st.abort:
                        raise ShardError(
                            f"super-step {step} aborted for recovery"
                        )
                    waiting = [p for p in peers
                               if (step, p) not in st.inbox]
                    if not waiting:
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        raise PeerUnreachable(
                            waiting[0],
                            f"no halo frame for step {step} within "
                            "barrier timeout",
                        )
                    st.cond.wait(min(remaining, 1.0))
                for peer in peers:
                    ghost.update(st.inbox.pop((step, peer)))
                # Anything older is unreachable now (barrier passed).
                for key in [k for k in st.inbox if k[0] < step]:
                    st.inbox.pop(key)
            new_board, changed = step_tiles(
                st.board, st.memo, st.stats, ghost=ghost, owned=st.owned)
            st.stats.generations += 1
            st.prev = st.board
            st.board = new_board
            st.step = step + 1
            st.last_reply = {
                "job": st.job, "step": st.step, "changed": bool(changed),
                "live": len(new_board.tiles),
                "stats": st.stats_tuple(),
            }
            return st.last_reply

    def checkpoint(self, job, step) -> dict:
        """POST /shard/checkpoint: the owned slice to the shard log."""
        st = self._get(job)
        step = int(step)
        if step != st.step:
            raise ShardError(
                f"checkpoint asked at step {step}; shard is at {st.step}"
            )
        st.ckpt_step = step
        st.ckpt_board = st.board
        st.ckpt_stats = st.stats_tuple()
        self._append(st, {
            "kind": "ckpt", "job": st.job, "step": step,
            "rle": st.board.to_rle(), "stats": st.stats_tuple(),
        })
        return {"job": st.job, "step": step, "durable": True}

    def rewind(self, job, step, peers=None) -> dict:
        """POST /shard/rewind: back to a checkpointed super-step (the
        survivors' half of recovery — in-memory when the barrier is the
        latest one taken, from the shard log otherwise). ``peers`` is the
        refreshed peer URL map: a respawned peer answers on a NEW port,
        and a survivor sending halos to the dead one would re-fail.

        Aborts a step blocked on the halo barrier first, then mutates
        under the gate — never two threads on one board."""
        st = self._get(job)
        step = int(step)
        with st.cond:
            st.abort = True
            st.cond.notify_all()
        st.gate.acquire()
        try:
            with st.cond:
                st.abort = False
            return self._rewind_locked(st, step, peers)
        finally:
            st.gate.release()

    def _rewind_locked(self, st: _ShardJob, step: int, peers) -> dict:
        if step == st.ckpt_step and st.ckpt_board is not None:
            st.board = st.ckpt_board
            st.load_stats(st.ckpt_stats)
        else:
            rec = self._scan_ckpt(st.log_path, step) if st.log_path else None
            if rec is None:
                raise ShardError(
                    f"no checkpoint at step {step} for shard job {st.job}"
                )
            st.board = SparseBoard.from_rle(
                rec["rle"], height=int(st.spec["height"]),
                width=int(st.spec["width"]), tile=int(st.spec["tile"]),
                owned=st.owned)
            st.load_stats(rec["stats"])
            st.ckpt_step = step
            st.ckpt_board = st.board
            st.ckpt_stats = st.stats_tuple()
        st.prev = None
        st.step = step
        st.last_reply = None
        if peers is not None:
            st.peers = {str(k): str(v) for k, v in peers.items()
                        if str(k) != st.self_id}
        with st.cond:
            # Frames for replayed steps arrive again with identical
            # bytes; anything buffered is from the abandoned timeline.
            st.inbox.clear()
        return {"job": st.job, "step": step, "live": len(st.board.tiles)}

    def restore_job(self, body: dict) -> dict:
        """POST /shard/restore: a respawned worker rebuilds its shard —
        and ONLY its shard — from its own log at the durable step."""
        st = self._build(body)
        step = int(body["step"])
        if st.job in self.jobs:
            return self.rewind(st.job, step, body.get("peers"))
        if st.log_path is None:
            raise ShardError("this worker has no shard log to restore from")
        rec = self._scan_ckpt(st.log_path, step)
        if rec is None:
            raise ShardError(
                f"no checkpoint at step {step} in {st.log_path}"
            )
        st.board = SparseBoard.from_rle(
            rec["rle"], height=int(st.spec["height"]),
            width=int(st.spec["width"]), tile=int(st.spec["tile"]),
            owned=st.owned)
        st.load_stats(rec["stats"])
        st.step = step
        st.ckpt_step = step
        st.ckpt_board = st.board
        st.ckpt_stats = st.stats_tuple()
        self._append(st, {"kind": "restore", "job": st.job, "step": step})
        with self.lock:
            self.jobs[st.job] = st
        obs_registry.default().inc("shard_restores_total")
        return {"job": st.job, "step": step, "live": len(st.board.tiles)}

    def status(self, job) -> dict:
        """POST /shard/status: liveness probe for recovery — does this
        process still hold the job, and at which step?"""
        st = self.jobs.get(str(job))
        if st is None:
            return {"job": str(job), "known": False}
        return {"job": st.job, "known": True, "step": st.step,
                "ckpt_step": st.ckpt_step, "live": len(st.board.tiles)}

    # -- elastic membership ------------------------------------------------

    def rebalance(self, body: dict) -> dict:
        """POST /shard/rebalance (at a checkpoint barrier): adopt the new
        membership, ship exactly the moved-out tiles to their new owners
        (HRW guarantees that is the minimal set), keep the rest."""
        st = self._get(body["job"])
        workers = [str(w) for w in body["workers"]]
        if st.self_id not in workers:
            # This worker is departing: everything it owns moves out.
            pass
        new_part = Partition(workers, st.partition.tiles_y,
                             st.partition.tiles_x)
        peers = {str(k): str(v) for k, v in (body.get("peers") or {}).items()
                 if str(k) != st.self_id}
        moving: dict[str, dict] = {}
        for coord, arr in list(st.board.tiles.items()):
            own = new_part.owner(coord)
            if own != st.self_id:
                moving.setdefault(own, {})[coord] = arr
        reg = obs_registry.default()
        for target, tiles in sorted(moving.items()):
            raw = halo.encode_tiles(st.job, st.step, st.self_id, tiles,
                                    st.board.tile)
            url = peers[target].rstrip("/") + "/shard/adopt"
            status, _ctype, resp = self.http_exchange(
                "POST", url, raw=raw, timeout=60,
                content_type=wire.CONTENT_TYPE,
            )
            if status not in (200, 202):
                raise ShardError(
                    f"tile transfer to {target} failed: HTTP {status} "
                    f"{resp.decode('utf-8', 'replace')[:200]}"
                )
            reg.inc("shard_rebalanced_tiles_total", len(tiles))
            for coord in tiles:
                st.board.tiles.pop(coord, None)
        departing = st.self_id not in workers
        if departing:
            with self.lock:
                self.jobs.pop(st.job, None)
        else:
            st.partition = new_part
            st.owned = new_part.owns(st.self_id)
            st.peers = peers
            st.prev = None
            st.last_reply = None
        moved = sum(len(t) for t in moving.values())
        return {"job": st.job, "step": st.step, "moved": moved,
                "departed": departing, "live": len(st.board.tiles)}

    def adopt(self, raw: bytes) -> dict:
        """POST /shard/adopt (packed): install migrated tiles."""
        meta, tiles = halo.decode_tiles(raw)
        st = self._get(meta["job"])
        for coord, arr in tiles.items():
            st.board.set_tile(coord, arr)
        return {"job": st.job, "adopted": len(tiles),
                "live": len(st.board.tiles)}

    # -- results -----------------------------------------------------------

    def collect(self, job, which: str = "current") -> dict:
        """POST /shard/collect: the owned slice as a full-geometry RLE
        document (only this worker's tiles are live in it — the
        coordinator merges the disjoint slices)."""
        st = self._get(job)
        if which == "prev":
            board = st.prev
            if board is None:
                raise ShardError(
                    f"shard job {st.job} holds no previous super-step"
                )
        elif which == "current":
            board = st.board
        else:
            raise ShardError(f"collect wants current|prev, got {which!r}")
        return {
            "job": st.job, "step": st.step, "rle": board.to_rle(),
            "live": len(board.tiles), "population": board.population(),
            "stats": st.stats_tuple(),
        }

    def finish(self, job) -> dict:
        """POST /shard/done: terminal audit record, state dropped."""
        job = str(job)
        with self.lock:
            st = self.jobs.pop(job, None)
            if job in self.finished:
                # A retried ack — or a recovery that restored state for a
                # job whose done record already landed ("frame landed, ack
                # lost" on the finish leg). Either way the audit record
                # exists; dropping state again is all that is left to do.
                return {"job": job, "done": True}
            if st is None:
                raise ShardError(f"unknown shard job {job}")
            self.finished.add(job)
        digest = hashlib.sha1(
            st.board.to_rle().encode("utf-8")).hexdigest()
        self._append(st, {
            "kind": "done", "job": job, "step": st.step,
            "live": len(st.board.tiles), "digest": digest,
        })
        return {"job": job, "done": True, "step": st.step}
