"""Persistent plan cache: fingerprinted JSON, atomic writes, loud fallbacks.

The port of ``gol_tpu/tune/plans.py``. One file (default
``~/.cache/gol_tpu_torch/plans.json``, overridable via the
``GOL_PLAN_CACHE`` env var or ``--plan-cache``) maps *fingerprints* to
measured plans. A fingerprint bakes in everything that invalidates a
measurement:

    schema version | torch version | CUDA version | kind | HxW | convention |
    state family | mesh RxC | device name

so a torch or CUDA upgrade, a schema change, another card or another mesh
simply *misses* — stale plans can never be served, only skipped.

The file's schema is the JAX package's, so one file can hold both
packages' plans: a JAX entry (``jax=`` in its key and its record) is a
clean miss here and the reverse, and each package's ``put`` keeps the
other's entries (an entry is pruned only when it is this package's and its
versions no longer match).

Durability follows the resilience staging discipline (the same
``.inprogress`` suffix the checkpoint/ts_store writers use): the new cache
body is written to a temp path, fsynced, and committed with ``os.replace``
— a crash mid-write leaves either the old cache or the new one, never a
torn file. Reads are tolerant anyway: an unreadable/torn cache logs a loud
warning and falls back to the bundled defaults (``default_plans.json``),
which encode the hard-coded ladders — a cold or corrupted machine behaves
exactly like the pre-tune engine.
"""

from __future__ import annotations

import dataclasses
import importlib.metadata
import json
import logging
import os
import tempfile

from gol_tpu_torch.resilience import STAGING_SUFFIX

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1
ENV_CACHE_PATH = "GOL_PLAN_CACHE"
_BUNDLED_DEFAULTS = os.path.join(os.path.dirname(__file__),
                                 "default_plans.json")


def default_cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "gol_tpu_torch", "plans.json")


def cache_path() -> str:
    return os.environ.get(ENV_CACHE_PATH) or default_cache_path()


def _versions() -> dict:
    # A function (not an import-time constant) so tests can patch it to
    # exercise version invalidation without another torch install.
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda or "none"}


def _neighbour_stamp() -> dict:
    """``{"jax": <version>}`` when the JAX package's runtime is installed
    beside the port, else ``{}``. The JAX package's ``put`` keeps only
    entries whose ``jax`` field equals its running version, so the port
    stamps its entries with it: a JAX commit to a shared file then keeps
    them (their keys still never match a JAX lookup). The version comes
    from the installed distribution's metadata; nothing is imported."""
    try:
        return {"jax": importlib.metadata.version("jax")}
    except importlib.metadata.PackageNotFoundError:
        return {}


def device_kind(device=None) -> str:
    """The name of the card a run uses (``cpu`` on the CPU lane)."""
    import torch

    from gol_tpu_torch import platform_env

    dev = platform_env.resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def fingerprint(
    kind: str,
    height: int,
    width: int,
    convention: str,
    family: str,
    mesh_shape: tuple[int, int],
    dev_kind: str,
) -> str:
    """The stable cache key. Every field is part of the string, so any
    mismatch — including the schema, torch and CUDA versions — is a clean
    miss."""
    versions = _versions()
    return "|".join(
        (
            f"schema={SCHEMA_VERSION}",
            f"torch={versions['torch']}",
            f"cuda={versions['cuda']}",
            f"kind={kind}",
            f"grid={height}x{width}",
            f"conv={convention}",
            f"family={family}",
            f"mesh={mesh_shape[0]}x{mesh_shape[1]}",
            f"device={dev_kind}",
        )
    )


@dataclasses.dataclass
class PlanStore:
    """Load/commit interface over one plans.json file.

    Loading is lazy and cached per instance; ``put`` re-reads the file
    first, so concurrent tuners lose at most their own entry, never the
    whole file (last ``os.replace`` wins per entry set).
    """

    path: str | None = None
    _entries: dict | None = dataclasses.field(default=None, repr=False)
    _defaults: dict | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.path is None:
            self.path = cache_path()

    # -- reads -------------------------------------------------------------

    def _read_file(self, path: str, *, bundled: bool) -> dict:
        try:
            with open(path, "r", encoding="utf-8") as f:
                body = json.load(f)
            entries = body["plans"]
            if not isinstance(entries, dict):
                raise ValueError(f"'plans' is {type(entries).__name__}, not a dict")
            return entries
        except FileNotFoundError:
            return {}
        except (OSError, ValueError, KeyError) as err:
            # A torn/partial cache (crash mid-write of a non-staging writer,
            # disk corruption, a hand edit) must degrade to defaults LOUDLY
            # — silently serving half a cache would look like a perf
            # regression with no trail.
            logger.warning(
                "%s plan file %s is unreadable (%s: %s); falling back to "
                "built-in ladder defaults",
                "bundled" if bundled else "cached", path,
                type(err).__name__, err,
            )
            return {}

    def entries(self) -> dict:
        if self._entries is None:
            self._entries = self._read_file(self.path, bundled=False)
        return self._entries

    def defaults(self) -> dict:
        if self._defaults is None:
            self._defaults = self._read_file(_BUNDLED_DEFAULTS, bundled=True)
        return self._defaults

    def get(self, fp: str) -> dict | None:
        """The plan dict stored under ``fp``, or None. The fingerprint
        carries the schema and versions, so no further staleness check is
        needed here — a stale entry cannot be addressed at all."""
        entry = self.entries().get(fp)
        if entry is None:
            return None
        plan = entry.get("plan")
        return plan if isinstance(plan, dict) else None

    def get_default(self, kind: str) -> dict | None:
        """Bundled fallback for ``kind`` ('engine' | 'serve'): version-less
        by design — defaults describe the built-in ladders, which travel
        with the code, not with a torch install."""
        entry = self.defaults().get(f"default:{kind}")
        if entry is None:
            return None
        plan = entry.get("plan")
        return plan if isinstance(plan, dict) else None

    # -- writes ------------------------------------------------------------

    def put(self, fp: str, plan: dict, measured: dict | None = None) -> None:
        """Insert/replace one entry and commit the file atomically.

        This package's entries whose recorded schema or versions no longer
        match the running ones are pruned on the way out; entries of
        another package (the JAX package's carry ``jax``, not ``torch``)
        are kept as they are.
        """
        current = self._read_file(self.path, bundled=False)
        versions = _versions()
        keep = {
            key: entry
            for key, entry in current.items()
            if isinstance(entry, dict) and (
                "torch" not in entry
                or (entry.get("schema") == SCHEMA_VERSION
                    and all(entry.get(k) == v for k, v in versions.items()))
            )
        }
        dropped = len(current) - len(keep)
        if dropped:
            logger.info("pruned %d stale plan cache entr%s from %s",
                        dropped, "y" if dropped == 1 else "ies", self.path)
        keep[fp] = {"schema": SCHEMA_VERSION, **versions, **_neighbour_stamp(),
                    "plan": dict(plan)}
        if measured is not None:
            keep[fp]["measured"] = measured
        self._commit(keep)
        self._entries = keep

    def _commit(self, entries: dict) -> None:
        body = {"schema": SCHEMA_VERSION, "plans": entries}
        directory = os.path.dirname(self.path) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=directory,
            prefix=os.path.basename(self.path) + ".",
            suffix=STAGING_SUFFIX,
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(body, f, indent=1, sort_keys=True)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
