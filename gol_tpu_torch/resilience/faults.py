"""Fault-injection plan: deterministic failures for the recovery harness.

The port's copy of ``gol_tpu/resilience/faults.py``: the same ``GOL_FAULTS``
/ ``--fault-plan`` keys, errors and probes, so one spec drives both
packages. The ``ts_*`` probes fire in the port's zarr store
(``io/ts_store.py``), which keeps JAX's "tensorstore" site names.

The crash-safety claims in ``resilience/checkpoint.py`` (a crash never leaves
the checkpoint dir without a readable prior state; auto-resume reproduces the
uninterrupted run byte-for-byte) are only claims until a harness kills real
runs at every boundary and fails writes mid-checkpoint. This module is that
harness's lever: a ``FaultPlan`` installed process-wide (by flag or env var)
that the IO and checkpoint layers probe at their injection points.

Production runs never install a plan, and every probe is a no-op ``None``
check — the hooks cost nothing when disarmed.

Knobs (``--fault-plan`` spec / ``GOL_FAULTS`` env var, ``k=v`` comma list):

- ``ts_write_fail=N``      fail the Nth tensorstore shard write (1-based,
                           counted process-wide)
- ``ts_write_error=hard|transient``  how that write fails (default hard)
- ``ts_open_transient=N``  first N tensorstore opens raise a transient error
- ``payload_write_fail=N`` fail the Nth checkpoint payload write mid-file
- ``kill_at_gen=K``        crash at the first checkpoint boundary whose
                           generation count is >= K
- ``kill_during_ckpt_write=N``  crash DURING the Nth checkpoint payload
                           write (the payload is torn mid-file first) —
                           with the async writer (gol_tpu_torch/pipeline) this
                           fires on the background writer thread, modeling
                           a process dying with a write in flight; the
                           last *committed* checkpoint must survive
- ``kill_mode=exception|sigkill``  simulated crash (``InjectedCrash``, a
                           BaseException no library layer catches) or a real
                           ``SIGKILL`` (subprocess harness only)

Filesystem exhaustion knobs (the storage-lifecycle harness: every durable
writer — journal, CAS, checkpoint, compaction snapshot — routes its bytes
through the ``resilience/fsio`` shim, whose probes these drive):

- ``enospc_after_bytes=N`` shim writes succeed until N cumulative bytes
                           have passed, then every write raises
                           ``OSError(ENOSPC)`` — a partition filling up
                           mid-run, deterministically
- ``eio_every=N``          every Nth shim write raises ``OSError(EIO)``
                           (flaky media, not exhaustion — retries may heal)
- ``full_disk=1``          every shim write raises ``ENOSPC`` immediately
                           and ``fsio.free_bytes`` reports 0 — the disk is
                           full from the first byte (drives the watchdog)
- ``disk_free_bytes=N``    pin ``fsio.free_bytes`` to N without failing
                           writes: the watchdog sees pressure before the
                           filesystem actually refuses anything
- ``kill_during_compaction=snapshot|retire``  crash a journal compaction at
                           its two durability boundaries — ``snapshot``
                           fires with the new snapshot fully staged but not
                           yet committed; ``retire`` fires after the commit
                           with the folded segments not yet deleted
- ``kill_during_cas_gc=N`` crash the CAS garbage collector mid-evict on its
                           Nth entry, between the meta unlink (the entry is
                           now invisible) and the payload unlink (an orphan
                           sidecar the next sweep must collect)
- ``kill_during_prune=N``  crash checkpoint pruning on its Nth doomed
                           checkpoint, after the manifest delete and before
                           the payload delete (the orphaned payload must be
                           invisible garbage to the next restore/GC)
"""

from __future__ import annotations

import dataclasses
import errno
import os


class InjectedCrash(BaseException):
    """A simulated hard kill. Derives from BaseException so no library-level
    ``except Exception`` can absorb it — like SIGKILL, nothing between the
    injection point and the process boundary gets to clean up."""


class TransientInjectedError(OSError):
    """An injected transient IO error; the message carries the marker
    ``retry.is_transient_io`` classifies on."""

    def __init__(self, site: str):
        super().__init__(f"injected transient fault at {site}")


class InjectedWriteError(OSError):
    """An injected hard IO failure (non-transient: retries must NOT heal it)."""

    def __init__(self, site: str):
        super().__init__(f"injected hard write fault at {site}")


@dataclasses.dataclass
class FaultPlan:
    """Declarative failure schedule; counters live in the instance so one
    plan drives exactly one run's worth of faults."""

    ts_write_fail: int | None = None
    ts_write_error: str = "hard"  # "hard" | "transient"
    ts_open_transient: int = 0
    payload_write_fail: int | None = None
    kill_at_gen: int | None = None
    kill_during_ckpt_write: int | None = None
    kill_mode: str = "exception"  # "exception" | "sigkill"
    # Filesystem exhaustion (probed by the resilience/fsio shim).
    enospc_after_bytes: int | None = None
    eio_every: int | None = None
    full_disk: int = 0
    disk_free_bytes: int | None = None
    kill_during_compaction: str | None = None  # "snapshot" | "retire"
    kill_during_cas_gc: int | None = None
    kill_during_prune: int | None = None

    _ts_writes: int = dataclasses.field(default=0, repr=False)
    _ts_opens: int = dataclasses.field(default=0, repr=False)
    _payload_writes: int = dataclasses.field(default=0, repr=False)
    _killed: bool = dataclasses.field(default=False, repr=False)
    _fs_bytes: int = dataclasses.field(default=0, repr=False)
    _fs_writes: int = dataclasses.field(default=0, repr=False)
    _cas_evicts: int = dataclasses.field(default=0, repr=False)
    _prunes: int = dataclasses.field(default=0, repr=False)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``k=v,k=v`` spec -> plan; unknown keys are loud errors so a typo'd
        injection never silently tests nothing."""
        plan = cls()
        ints = {"ts_write_fail", "ts_open_transient", "payload_write_fail",
                "kill_at_gen", "kill_during_ckpt_write",
                "enospc_after_bytes", "eio_every", "full_disk",
                "disk_free_bytes", "kill_during_cas_gc",
                "kill_during_prune"}
        strs = {"ts_write_error": ("hard", "transient"),
                "kill_mode": ("exception", "sigkill"),
                "kill_during_compaction": ("snapshot", "retire")}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, sep, value = part.partition("=")
            if not sep:
                raise ValueError(f"fault plan entry {part!r} is not k=v")
            if key in ints:
                setattr(plan, key, int(value))
            elif key in strs:
                if value not in strs[key]:
                    raise ValueError(
                        f"fault plan {key} must be one of {strs[key]}, "
                        f"got {value!r}")
                setattr(plan, key, value)
            else:
                raise ValueError(f"unknown fault plan key {key!r}")
        return plan

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        spec = os.environ.get("GOL_FAULTS")
        return cls.parse(spec) if spec else None


_active: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    """Arm ``plan`` process-wide (None disarms)."""
    global _active
    _active = plan


def clear() -> None:
    install(None)


# --- injection points -------------------------------------------------------
# Each probe is called by exactly one library site; the site string rides the
# raised error so a harness assertion can name where the fault landed.


def on_ts_open() -> None:
    plan = _active
    if plan is None:
        return
    if plan._ts_opens < plan.ts_open_transient:
        plan._ts_opens += 1
        raise TransientInjectedError("tensorstore open")
    plan._ts_opens += 1


def on_ts_shard_write(shard_index: int) -> None:
    plan = _active
    if plan is None:
        return
    plan._ts_writes += 1
    if plan.ts_write_fail is not None and plan._ts_writes == plan.ts_write_fail:
        site = f"tensorstore shard write #{plan._ts_writes} (shard {shard_index})"
        if plan.ts_write_error == "transient":
            raise TransientInjectedError(site)
        raise InjectedWriteError(site)


def _tear(path: str) -> None:
    """Corrupt ``path`` the way a crash mid-write would: truncate the file
    to half its bytes (directory payloads: tear the largest file inside)."""
    target = path
    if os.path.isdir(path):
        candidates = []
        for root, _, names in os.walk(path):
            for name in names:
                p = os.path.join(root, name)
                try:
                    candidates.append((os.path.getsize(p), p))
                except OSError:
                    pass
        if not candidates:
            return
        target = max(candidates)[1]
    try:
        with open(target, "r+b") as f:
            f.truncate(os.path.getsize(target) // 2)
    except OSError:
        pass


def on_payload_write(path: str) -> None:
    """Probed right after a checkpoint payload write completes; a firing
    fault TEARS the written payload (mid-file truncation) before raising, so
    the harness proves restore() treats torn payloads as invisible garbage —
    not merely that an error aborts the manifest commit.

    ``kill_during_ckpt_write`` fires here too, but as a process CRASH
    rather than an I/O error: with the async checkpoint writer this probe
    runs on the background ``gol-ckpt-writer`` thread, so the kill models
    exactly the window the deferred-commit discipline protects — a death
    with a payload write in flight, its manifest never committed. The
    payload is torn first (the write was "mid-file"), the flight recorder
    dumps (sigkill gets no unwinding), then ``kill_mode`` decides SIGKILL
    vs ``InjectedCrash`` (which the writer thread parks and the main thread
    re-raises at its next drain — the deferred MPI_Wait status)."""
    plan = _active
    if plan is None:
        return
    plan._payload_writes += 1
    if (
        plan.kill_during_ckpt_write is not None
        and plan._payload_writes == plan.kill_during_ckpt_write
        and not plan._killed
    ):
        plan._killed = True
        _tear(path)
        from gol_tpu_torch.obs import recorder

        recorder.trigger(
            f"fault-injection: kill during checkpoint payload write "
            f"{path} ({plan.kill_mode})"
        )
        if plan.kill_mode == "sigkill":
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(
            f"injected crash during checkpoint payload write {path}"
        )
    if (
        plan.payload_write_fail is not None
        and plan._payload_writes == plan.payload_write_fail
    ):
        _tear(path)
        raise InjectedWriteError(f"checkpoint payload write {path}")


def _crash(site: str) -> None:
    """The shared kill tail: dump the flight recorder, then SIGKILL or raise
    ``InjectedCrash`` per the plan's ``kill_mode`` (exactly the
    ``on_checkpoint_boundary`` discipline — sigkill gets no unwinding, so
    the dump must happen here)."""
    plan = _active
    from gol_tpu_torch.obs import recorder

    recorder.trigger(f"fault-injection: kill at {site} ({plan.kill_mode})")
    if plan.kill_mode == "sigkill":
        import signal

        os.kill(os.getpid(), signal.SIGKILL)
    raise InjectedCrash(f"injected crash at {site}")


def on_fs_write(nbytes: int, site: str) -> None:
    """Probed by ``resilience/fsio`` before every shim write: the
    exhaustion knobs fire here, with real errno values so the callers'
    ENOSPC/EIO handling is exercised verbatim."""
    plan = _active
    if plan is None:
        return
    plan._fs_writes += 1
    if plan.full_disk:
        raise OSError(errno.ENOSPC,
                      f"injected full disk at {site}")
    if plan.eio_every and plan._fs_writes % plan.eio_every == 0:
        raise OSError(errno.EIO,
                      f"injected EIO at {site} (write #{plan._fs_writes})")
    plan._fs_bytes += nbytes
    if (plan.enospc_after_bytes is not None
            and plan._fs_bytes > plan.enospc_after_bytes):
        raise OSError(
            errno.ENOSPC,
            f"injected ENOSPC at {site} ({plan._fs_bytes} bytes past the "
            f"{plan.enospc_after_bytes}-byte budget)")


def fs_free_bytes() -> int | None:
    """The watchdog's injected free-byte reading, or None (read the real
    filesystem). ``full_disk`` reports 0 so the pressure plane and the
    write failures agree on the world."""
    plan = _active
    if plan is None:
        return None
    if plan.full_disk:
        return 0
    return plan.disk_free_bytes


def on_compaction(stage: str) -> None:
    """Probed at a journal compaction's two durability boundaries:
    ``snapshot`` right before the atomic commit (staged, uncommitted) and
    ``retire`` right after it (committed, folded segments still on disk)."""
    plan = _active
    if plan is None or plan._killed:
        return
    if plan.kill_during_compaction == stage:
        plan._killed = True
        _crash(f"journal compaction ({stage} boundary)")


def on_cas_evict(fp: str) -> None:
    """Probed by the CAS garbage collector between an evicted entry's meta
    unlink and its payload unlink — the orphan-sidecar window."""
    plan = _active
    if plan is None or plan._killed or plan.kill_during_cas_gc is None:
        return
    plan._cas_evicts += 1
    if plan._cas_evicts == plan.kill_during_cas_gc:
        plan._killed = True
        _crash(f"CAS GC evict #{plan._cas_evicts} ({fp})")


def on_checkpoint_prune(path: str) -> None:
    """Probed by checkpoint pruning between a doomed checkpoint's manifest
    delete and its payload delete: a kill here leaves an orphaned payload
    that must be invisible garbage to the next restore (and swept by the
    next prune)."""
    plan = _active
    if plan is None or plan._killed or plan.kill_during_prune is None:
        return
    plan._prunes += 1
    if plan._prunes == plan.kill_during_prune:
        plan._killed = True
        _crash(f"checkpoint prune ({path})")


def on_checkpoint_boundary(generation: int) -> None:
    """Probed at every checkpoint boundary BEFORE the checkpoint is written:
    a kill here models dying between checkpoints, so the newest durable state
    is the previous boundary's."""
    plan = _active
    if plan is None or plan._killed or plan.kill_at_gen is None:
        return
    if generation >= plan.kill_at_gen:
        plan._killed = True
        # Flight-recorder composition: a kill about to happen is exactly the
        # moment the recorder exists for. The sigkill mode gets no Python
        # unwinding (no excepthook), so the dump MUST happen here; the
        # exception mode dumps here too so a harness that catches
        # InjectedCrash still leaves post-mortem evidence. Unarmed, this is
        # one None check (obs.recorder keeps no other state).
        from gol_tpu_torch.obs import recorder

        recorder.trigger(
            f"fault-injection: kill at checkpoint boundary, "
            f"generation {generation} ({plan.kill_mode})"
        )
        if plan.kill_mode == "sigkill":
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(f"injected crash at checkpoint boundary, "
                            f"generation {generation}")
