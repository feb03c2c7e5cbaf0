"""Exactly-once under SIGKILL mid-ring, across the packages.

Mirrors ``tests/test_megabatch.py``'s ``TestSigkillMidRing`` with real
subprocesses: a resident-ring server (``serve --resident-ring 4
--pipeline-depth 8 --journal-dir J``) is SIGKILLed once the journal holds
its first ``done`` record (waited on, not slept for), a server of either
package restarts on the same journal and replays it, and every accepted job
ends DONE exactly once, equal to a solo run. Three pairs: the port's server
killed and restarted, a JAX journal replayed by the port's resident server,
and the port's journal replayed by JAX's. Every wait has its own deadline.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gol_tpu_torch import engine
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.serve.jobs import JobJournal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NJOBS, SIDE, GEN_LIMIT = 16, 64, 800
DEADLINE_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method, url, body=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _start(package: str, port: int, journal_dir: str) -> subprocess.Popen:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "GOL_TORCH_DEVICE": "cpu"}
    return subprocess.Popen(
        [sys.executable, "-m", package, "serve", "--port", str(port),
         "--journal-dir", journal_dir, "--flush-age", "0.001",
         "--max-batch", "4", "--pipeline-depth", "8", "--resident-ring", "4",
         "--sample-interval", "0"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _until(predicate, what: str, timeout=DEADLINE_S, interval=0.005):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _wait_serving(proc, url):
    def up():
        if proc.poll() is not None:
            raise RuntimeError(f"server died rc={proc.returncode}: "
                               f"{proc.stdout.read()}")
        try:
            return _http("GET", url + "/healthz", timeout=5)[0] == 200
        except (urllib.error.URLError, OSError):
            return False

    _until(up, "the server to answer /healthz", interval=0.05)


def _events(journal_dir):
    path = os.path.join(journal_dir, JobJournal.FILENAME)
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        try:
            out.append(json.loads(line))
        except ValueError:
            pass  # the record a SIGKILL tore
    return out


def _dones(journal_dir):
    return [e for e in _events(journal_dir) if e.get("event") == "done"]


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.parametrize("first, second", [
    ("gol_tpu_torch", "gol_tpu_torch"),
    ("gol_tpu", "gol_tpu_torch"),
    ("gol_tpu_torch", "gol_tpu"),
], ids=["port", "jax_then_port", "port_then_jax"])
def test_exactly_once_after_sigkill_mid_ring_and_replay(first, second, tmp_path):
    journal_dir = str(tmp_path / "journal")
    boards = [text_grid.generate(SIDE, SIDE, seed=5000 + i)
              for i in range(NJOBS)]
    payloads = [{"width": SIDE, "height": SIDE, "gen_limit": GEN_LIMIT,
                 "cells": text_grid.encode(b).decode("ascii")} for b in boards]

    url = f"http://127.0.0.1:{_free_port()}"
    proc = _start(first, int(url.rsplit(":", 1)[1]), journal_dir)
    ids = []
    try:
        _wait_serving(proc, url)
        for payload in payloads:
            code, out = _http("POST", url + "/jobs", payload)
            assert code == 202, out
            ids.append(out["id"])
        # Kill without any Python unwinding once drains have landed work
        # in the journal and others are still in flight.
        _until(lambda: _dones(journal_dir), "the first done record")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    done_before = {e["id"] for e in _dones(journal_dir)}
    assert 0 < len(done_before) < NJOBS

    url2 = f"http://127.0.0.1:{_free_port()}"
    proc2 = _start(second, int(url2.rsplit(":", 1)[1]), journal_dir)
    results = {}
    try:
        _wait_serving(proc2, url2)

        def all_done():
            for jid in ids:
                if jid not in results:
                    code, out = _http("GET", f"{url2}/result/{jid}")
                    if code != 200:
                        return False
                    results[jid] = out
            return True

        _until(all_done, "every job's result", interval=0.05)
    finally:
        _stop(proc2)

    config = GameConfig(gen_limit=GEN_LIMIT)
    for jid, board in zip(ids, boards):
        want = engine.simulate(board, config, device="cpu")
        got = text_grid.decode(results[jid]["grid"].encode("ascii"), SIDE, SIDE)
        assert np.array_equal(got, want.grid)
        assert results[jid]["generations"] == want.generations
    dones = _dones(journal_dir)
    for jid in ids:
        assert sum(e.get("id") == jid for e in dones) == 1, jid
