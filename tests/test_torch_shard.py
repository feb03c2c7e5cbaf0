"""The port's sharded single-job lane (gol_tpu_torch/shard) against the JAX
package's (gol_tpu/shard) and both packages' sparse engines, on the CPU.

- Tile ownership (HRW over ``fleet/placement``): the same owner for every
  tile, the same moved set on a join and a retire, at N = 2, 3, 4.
- Halo frames: the same rings for the same slices, and the same frame
  bytes; each package decodes the other's frames.
- ``LocalCluster`` runs at N = 2 and 3 under both conventions (glider,
  Gosper gun, r-pentomino; the empty and similar exits; a pattern
  straddling a tile corner): the result document equals the JAX
  package's (RLE, generations, exit reason, stats, ownership, super-steps),
  and the board equals ``simulate_sparse``'s in both packages.
- The kill drill: a participant that loses its host right after super-step
  K (its process gone before the ack) is restored from its own shard log
  at the durable floor while the others rewind; exactly one recovery, and
  the same document as JAX's under the same drill. The kill is placed by
  the participant wrapper, not by the wall clock, so the run cannot end
  before it or land it elsewhere.
"""

import time

import pytest

from gol_tpu.config import GameConfig as JaxGameConfig
from gol_tpu.shard import coordinator as jax_coordinator
from gol_tpu.shard import halo as jax_halo
from gol_tpu.shard import partition as jax_partition
from gol_tpu.sparse import SparseBoard as JaxBoard
from gol_tpu.sparse import TileMemo as JaxMemo
from gol_tpu.sparse import simulate_sparse as jax_simulate_sparse
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.shard import coordinator, halo, partition
from gol_tpu_torch.shard.worker import ShardHost
from gol_tpu_torch.sparse import SparseBoard, TileMemo, simulate_sparse

GLIDER_RLE = "x = 3, y = 3, rule = B3/S23\nbob$2bo$3o!"
RPENTO_RLE = "x = 3, y = 3\nb2o$2o$bo!"
DOMINO_RLE = "x = 2, y = 1\n2o!"  # dies in one generation: the empty exit
BLOCK_RLE = "x = 2, y = 2\n2o$2o!"  # a still life: the similar exit
GOSPER_RLE = """x = 36, y = 9, rule = B3/S23
24bo$22bobo$12b2o6b2o12b2o$11bo3bo4b2o12b2o$2o8bo5bo3b2o$2o8bo3bob2o4b
obo$10bo5bo7bo$11bo3bo$12b2o!"""

H = W = 768
TILE = 256
CONVENTIONS = [Convention.C, Convention.CUDA]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _ids(n):
    return [f"w{i}" for i in range(n)]


def _coords(ty, tx):
    return [(y, x) for y in range(ty) for x in range(tx)]


# ---------------------------------------------------------------------------
# Ownership


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ownership_matches_jax(n):
    for ty, tx in ((3, 3), (6, 6), (16, 16), (4, 9)):
        port = partition.Partition(_ids(n), ty, tx)
        jax = jax_partition.Partition(_ids(n), ty, tx)
        coords = _coords(ty, tx)
        assert [port.owner(c) for c in coords] == [jax.owner(c) for c in coords]
        assert port.counts(coords) == jax.counts(coords)
        assert [port.neighbors(c) for c in coords] == \
            [jax.neighbors(c) for c in coords]
        assert partition.tile_label(ty, tx) == jax_partition.tile_label(ty, tx)


@pytest.mark.parametrize("n", [2, 3])
def test_moved_tiles_match_jax(n):
    coords = _coords(16, 16)
    for old, new in ((_ids(n), _ids(n + 1)),
                     (_ids(n + 1), [w for w in _ids(n + 1) if w != "w1"])):
        port = partition.moved_tiles(partition.Partition(old, 16, 16),
                                     partition.Partition(new, 16, 16), coords)
        jax = jax_partition.moved_tiles(jax_partition.Partition(old, 16, 16),
                                        jax_partition.Partition(new, 16, 16),
                                        coords)
        assert port == jax and port


def test_for_universe_refusal_matches_jax():
    with pytest.raises(ValueError) as port:
        partition.Partition.for_universe(_ids(2), 1000, 1024, 256)
    with pytest.raises(ValueError) as jax:
        jax_partition.Partition.for_universe(_ids(2), 1000, 1024, 256)
    assert str(port.value) == str(jax.value)


# ---------------------------------------------------------------------------
# Halo frames


def _slices(n, rle, x, y):
    """Each worker's slice of the same universe, in both packages."""
    port_part = partition.Partition(_ids(n), H // TILE, W // TILE)
    jax_part = jax_partition.Partition(_ids(n), H // TILE, W // TILE)
    port = {w: SparseBoard.from_rle(rle, height=H, width=W, tile=TILE, x=x,
                                    y=y, owned=port_part.owns(w))
            for w in _ids(n)}
    jax = {w: JaxBoard.from_rle(rle, height=H, width=W, tile=TILE, x=x, y=y,
                                owned=jax_part.owns(w))
           for w in _ids(n)}
    return port_part, jax_part, port, jax


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("where", [(250, 250), (TILE - 1, TILE - 1),
                                   (2 * TILE - 18, 5)],
                         ids=["inside", "corner", "edge"])
def test_halo_frames_match_jax(n, where):
    x, y = where
    port_part, jax_part, port, jax = _slices(n, GOSPER_RLE, x, y)
    for w in _ids(n):
        out = halo.outgoing(port[w], port_part, w)
        jax_out = jax_halo.outgoing(jax[w], jax_part, w)
        assert {p: sorted(e) for p, e in out.items()} == \
            {p: sorted(e) for p, e in jax_out.items()}
        for peer in _ids(n):
            if peer == w:
                continue
            raw = halo.encode("job", 7, w, out.get(peer) or {}, TILE)
            jax_raw = jax_halo.encode("job", 7, w, jax_out.get(peer) or {}, TILE)
            assert raw == jax_raw
            meta, rings = jax_halo.decode(raw)
            port_meta, port_rings = halo.decode(jax_raw)
            assert meta == port_meta
            assert sorted(rings) == sorted(port_rings)
            for coord, ring in rings.items():
                for a, b in zip(ring, port_rings[coord]):
                    assert (a == b).all()


def test_tile_frames_match_jax():
    port_part, jax_part, port, jax = _slices(2, GOSPER_RLE, TILE - 1, TILE - 1)
    for w in _ids(2):
        raw = halo.encode_tiles("job", 4, w, dict(port[w].tiles), TILE)
        assert raw == jax_halo.encode_tiles("job", 4, w, dict(jax[w].tiles), TILE)
        meta, tiles = jax_halo.decode_tiles(raw)
        port_meta, port_tiles = halo.decode_tiles(raw)
        assert meta == port_meta and sorted(tiles) == sorted(port_tiles)
        assert all((tiles[c] == port_tiles[c]).all() for c in tiles)


# ---------------------------------------------------------------------------
# LocalCluster against JAX's and both sparse engines


def _spec(rle, conv, gen_limit, x=250, y=250):
    cfg = GameConfig(gen_limit=gen_limit, convention=conv)
    return {"rle": rle, "x": x, "y": y, "height": H, "width": W,
            "tile": TILE, "convention": conv, "gen_limit": gen_limit,
            "check_similarity": cfg.check_similarity,
            "similarity_frequency": cfg.similarity_frequency}


def _run(mod, tmp_path, tag, spec, n, wrap=None, **kwargs):
    """One coordinator run over a ``LocalCluster`` of ``mod`` (either
    package's coordinator module)."""
    cluster = mod.LocalCluster(_ids(n), journal_root=str(tmp_path / tag))
    participants = cluster.participants()
    if wrap is not None:
        participants = wrap(cluster, participants)
    return mod.ShardCoordinator("job", spec, participants,
                                checkpoint_every=kwargs.pop("checkpoint_every", 8),
                                **kwargs).run()


def _solo(spec):
    """(RLE, generations, exit reason) of both packages' simulate_sparse."""
    out = []
    for board_cls, cfg_cls, memo, simulate in (
            (SparseBoard, GameConfig, TileMemo, simulate_sparse),
            (JaxBoard, JaxGameConfig, JaxMemo, jax_simulate_sparse)):
        board = board_cls.from_rle(spec["rle"], height=H, width=W, tile=TILE,
                                   x=spec["x"], y=spec["y"])
        res = simulate(board, cfg_cls(gen_limit=spec["gen_limit"],
                                      convention=spec["convention"]), memo())
        out.append((res.board.to_rle(), res.generations, res.exit_reason))
    assert out[0] == out[1]
    return out[0]


LOADS = {
    "glider": (GLIDER_RLE, 40, 250, 250),
    "gun": (GOSPER_RLE, 36, 250, 250),
    "r_pentomino": (RPENTO_RLE, 40, 250, 250),
    "empty": (DOMINO_RLE, 40, 250, 250),
    "similar": (BLOCK_RLE, 40, 250, 250),
    "straddling": (RPENTO_RLE, 32, TILE - 1, TILE - 1),
}


@pytest.mark.parametrize("conv", CONVENTIONS)
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("load", list(LOADS))
def test_local_cluster_matches_jax_and_sparse(load, n, conv, tmp_path):
    rle, gens, x, y = LOADS[load]
    spec = _spec(rle, conv, gens, x, y)
    res = _run(coordinator, tmp_path, "port", spec, n)
    want = _run(jax_coordinator, tmp_path, "jax", spec, n)
    assert res == want
    assert (res["rle"], res["generations"], res["exit_reason"]) == _solo(spec)
    if load in ("empty", "similar"):
        assert res["exit_reason"] == load


# ---------------------------------------------------------------------------
# The kill drill


def _kill_after(step: int, victim: str, mod):
    """Wrap a cluster's participants: ``victim``'s host runs super-step
    ``step`` to its end, then its process is lost before the ack (the
    host dropped, a fresh one respawned on the same journal directory) —
    once. Everything the peers needed from it for that step was sent, so
    no one waits on a barrier: the drill is deterministic."""

    class KillAfter:
        def __init__(self, cluster, inner):
            self._cluster, self._inner, self.fired = cluster, inner, False

        def __getattr__(self, name):
            return getattr(self._inner, name)

        @property
        def job(self):
            return self._inner.job

        @job.setter
        def job(self, value):
            self._inner.job = value

        def step(self, k):
            reply = self._inner.step(k)
            if k == step and not self.fired:
                self.fired = True
                self._cluster.kill(victim)
                self._cluster.respawn(victim)
                raise mod.ShardPeerDown(victim, "killed after its step")
            return reply

    def wrap(cluster, participants):
        return [KillAfter(cluster, p) if p.id == victim else p
                for p in participants]

    return wrap


@pytest.mark.parametrize("conv", CONVENTIONS)
@pytest.mark.parametrize("step", [9, 12])
def test_kill_drill_recovers_once_as_jax(conv, step, tmp_path):
    """Killed past the durable floor at 8: the fresh host restores its
    slice from its own shard log, the survivors rewind, the run re-runs
    from 8 and ends on the solo board with exactly one recovery."""
    spec = _spec(GLIDER_RLE, conv, 40)
    res = _run(coordinator, tmp_path, "port", spec, 3,
               wrap=_kill_after(step, "w1", coordinator), checkpoint_every=4,
               probe_interval=0.01, recover_timeout=30)
    want = _run(jax_coordinator, tmp_path, "jax", spec, 3,
                wrap=_kill_after(step, "w1", jax_coordinator),
                checkpoint_every=4, probe_interval=0.01, recover_timeout=30)
    assert res["recoveries"] == 1
    assert res == want
    assert (res["rle"], res["generations"], res["exit_reason"]) == _solo(spec)


def test_respawned_host_restores_only_its_own_slice(tmp_path):
    spec = _spec(GLIDER_RLE, Convention.C, 8)
    cluster = coordinator.LocalCluster(_ids(2), journal_root=str(tmp_path))
    coordinator.ShardCoordinator("job", spec, cluster.participants(),
                                 checkpoint_every=4).run()
    cluster.kill("w1")
    host = cluster.respawn("w1")
    assert isinstance(host, ShardHost)
    reply = host.restore_job({"job": "job", "spec": spec, "self": "w1",
                              "workers": _ids(2), "step": 4,
                              "peers": {"w0": "local://w0"}})
    assert reply["step"] == 4
    status = host.status("job")
    assert status["known"] and status["step"] == 4


def test_recovery_does_not_wait_for_a_blocked_straggler(tmp_path):
    """The victim dies after its peers sent it their step-K frames and
    before it sent its own: the peers block on their halo barriers. The
    port's coordinator recovers at once, its rewind aborting those
    barriers; the JAX package's waits for them first (here the hosts'
    barrier timeout, 300 s)."""
    spec = _spec(GLIDER_RLE, Convention.C, 40)
    step, victim = 9, "w1"

    class DiesBeforeSending:
        def __init__(self, cluster, inner):
            self._cluster, self._inner, self.fired = cluster, inner, False

        def __getattr__(self, name):
            return getattr(self._inner, name)

        @property
        def job(self):
            return self._inner.job

        @job.setter
        def job(self, value):
            self._inner.job = value

        def step(self, k):
            if k != step or self.fired:
                return self._inner.step(k)
            self.fired = True
            inbox = self._cluster.hosts[victim].jobs[self.job].inbox
            peers = {w for w in _ids(3) if w != victim}
            deadline = time.perf_counter() + 30
            while {p for s, p in list(inbox) if s == k} != peers:
                assert time.perf_counter() < deadline
                time.sleep(0.001)
            self._cluster.kill(victim)
            self._cluster.respawn(victim)
            raise coordinator.ShardPeerDown(victim, "killed before sending")

    def wrap(cluster, participants):
        return [DiesBeforeSending(cluster, p) if p.id == victim else p
                for p in participants]

    t0 = time.perf_counter()
    res = _run(coordinator, tmp_path, "port", spec, 3, wrap=wrap,
               checkpoint_every=4, probe_interval=0.01, recover_timeout=30)
    assert time.perf_counter() - t0 < 60
    assert res["recoveries"] == 1
    assert (res["rle"], res["generations"], res["exit_reason"]) == _solo(spec)
