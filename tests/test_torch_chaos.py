"""The port's chaos tier (gol_tpu_torch/chaos, fleet/breaker.py, the
deadline header and the retry budget) against the JAX package's, on the
CPU.

- Plans: the same fields for the same ``k=v`` specs and the same refusals;
  the same seeded fault stream (kind, draw, flip side) for the same seed,
  salt and mix.
- ``_flip_bit``: the same bytes for the same body and draw; every flip of
  a ``GOLP`` frame is caught by the port's CRC gate.
- Circuit breakers: one event script (failures, slow and fast successes,
  probes, an injected clock) walks both packages' breakers through the
  same states, penalties, public snapshots and transitions.
- Deadlines: the same ``X-Gol-Deadline`` codec, and both routers answer a
  spent, a live and a malformed budget alike (status, error, forwarded
  header and hop timeout).
- Retry budgets and backoff: the same tokens, refills, attempts and
  jittered sleeps.
- The proxy: both packages' proxies, with one seeded plan in front of one
  upstream, fault the same exchanges of a sequential client.
"""

import dataclasses
import json
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from gol_tpu.chaos import plan as jax_plan
from gol_tpu.chaos import proxy as jax_proxy
from gol_tpu.fleet import breaker as jax_breaker
from gol_tpu.fleet import router as jax_router
from gol_tpu.fleet import workers as jax_workers
from gol_tpu.obs import propagate as jax_propagate
from gol_tpu.resilience import retry as jax_retry
from gol_tpu_torch.chaos import plan, proxy
from gol_tpu_torch.fleet import breaker, client, router, workers
from gol_tpu_torch.io import text_grid, wire
from gol_tpu_torch.obs import propagate
from gol_tpu_torch.resilience import retry


class _Clock:
    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now


# ---------------------------------------------------------------------------
# Plans and seeded schedules


SPECS = ["", "seed=3", "seed=7,reset=0.05,latency=0.2,latency_ms=50,bitflip=0.125",
         "seed=777,refuse=0.2,reset=0.1", "truncate=1,slowloris=0.5,slow_ms=5,"
         "slow_chunk=64", " seed=9 , latency=1 "]


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_plans_parse_as_jax(spec):
    port, jax = plan.ChaosPlan.parse(spec), jax_plan.ChaosPlan.parse(spec)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert port.any_faults() == jax.any_faults()
    assert plan.FAULT_KINDS == jax_plan.FAULT_KINDS


@pytest.mark.parametrize("spec", ["restet=0.5", "reset", "reset=1.5",
                                  "bitflip=-0.1", "latency_ms=-1",
                                  "slow_chunk=0", "seed=x", "reset=0.1,reset",
                                  "seed = 9"])
def test_plan_refusals_match_jax(spec):
    errors = []
    for mod in (plan, jax_plan):
        with pytest.raises(ValueError) as err:
            mod.ChaosPlan.parse(spec)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("kwargs", [
    {"seed": 11, "reset": 0.3, "latency": 0.3, "bitflip": 0.2},
    {"seed": 5, "latency": 1.0}, {"seed": 5, "truncate": 1.0},
    {"seed": 777, "refuse": 0.2, "reset": 0.1},
    {"seed": 0, "refuse": 0.1, "reset": 0.1, "truncate": 0.1,
     "slowloris": 0.1, "bitflip": 0.1, "latency": 0.1},
], ids=range(5))
@pytest.mark.parametrize("salt", [0, 1, 17])
def test_seeded_rolls_match_jax(kwargs, salt):
    port = plan.ChaosPlan(**kwargs).schedule(salt=salt)
    jax = jax_plan.ChaosPlan(**kwargs).schedule(salt=salt)
    assert [port.next_fault() for _ in range(200)] == \
        [jax.next_fault() for _ in range(200)]


# ---------------------------------------------------------------------------
# Bit flips


def _frame():
    return wire.encode_frame({"gen_limit": 4}, grid=text_grid.generate(32, 32, seed=9))


@pytest.mark.parametrize("body", ["frame", "plain", "tiny", "empty"])
def test_flip_bit_matches_jax(body):
    data = {"frame": _frame(), "plain": bytes(range(200)) + bytes(200),
            "tiny": b"x", "empty": b""}[body]
    for i in range(257):
        draw = i / 256.0 if i < 256 else 0.999999
        flipped = proxy._flip_bit(data, draw)
        assert flipped == jax_proxy._flip_bit(data, draw)
        if body == "frame":
            with pytest.raises(wire.WireError, match="CRC"):
                wire.decode_frame(flipped)


# ---------------------------------------------------------------------------
# Circuit breakers


BREAKER_SCRIPTS = {
    "trip_and_recover": [("fail",), ("fail",), ("fail",), ("tick", 6.0),
                         ("attempt",), ("attempt",), ("ok", 0.01)],
    "failed_probe": [("fail",)] * 3 + [("tick", 6.0), ("attempt",), ("fail",),
                                       ("tick", 5.1), ("attempt",), ("ok", 0.2)],
    "slow_probe": [("fail",)] * 3 + [("tick", 6.0), ("attempt",), ("ok", 3.0)],
    "brownout": [("ok", 2.0 if i % 2 == 0 else 0.01) for i in range(10)],
    "resets": [("fail",), ("fail",), ("ok", 0.01)] * 4,
    "reopen": [("ok", 0.01), ("reopen",), ("tick", 1.0), ("attempt",),
               ("tick", 5.0), ("attempt",), ("ok", 0.01)],
}


@pytest.mark.parametrize("script", list(BREAKER_SCRIPTS))
@pytest.mark.parametrize("config", [
    {"fail_threshold": 3, "cooldown_s": 5.0},
    {"fail_threshold": 100, "window": 10, "min_volume": 10,
     "degraded_rate": 0.5, "slow_s": 1.0},
    {"fail_threshold": 3, "cooldown_s": 5.0, "min_volume": 100, "slow_s": None},
], ids=["threshold", "windowed", "no_latency_signal"])
def test_breakers_walk_as_jax(script, config):
    def walk(mod):
        clock, transitions = _Clock(), []
        br = mod.CircuitBreaker(
            mod.BreakerConfig(**config), clock=clock, label="w0",
            on_transition=lambda label, old, new: transitions.append((label, old, new)))
        trace = []
        for event, *arg in BREAKER_SCRIPTS[script]:
            if event == "fail":
                br.on_failure()
            elif event == "ok":
                br.on_success(arg[0])
            elif event == "attempt":
                trace.append(br.on_attempt())
            elif event == "tick":
                clock.now += arg[0]
            elif event == "reopen":
                br.reopen()
            trace.append((br.state, br.penalty(), br.public()))
        return trace, transitions

    assert walk(breaker) == walk(jax_breaker)


@pytest.mark.parametrize("kwargs", [{"fail_threshold": 0}, {"degraded_rate": 0.0},
                                    {"slow_s": 0.0}, {"cooldown_s": -1.0},
                                    {"window": 0}])
def test_breaker_config_refusals_match_jax(kwargs):
    errors = []
    for mod in (breaker, jax_breaker):
        with pytest.raises(ValueError) as err:
            mod.BreakerConfig(**kwargs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Deadlines


@pytest.mark.parametrize("value", ["1.25", "0.5", "-0.1", None, "", "soon",
                                   "nan", "inf", 7, "1e3"])
def test_deadline_codec_matches_jax(value):
    assert propagate.decode_deadline(value) == jax_propagate.decode_deadline(value)
    assert propagate.DEADLINE_HEADER == jax_propagate.DEADLINE_HEADER
    assert propagate.encode_deadline(1.25) == jax_propagate.encode_deadline(1.25)


@pytest.mark.parametrize("header", [None, "-0.5", "5.0", "whenever", "0.000001"])
@pytest.mark.parametrize("breakers", [False, True])
def test_router_deadlines_match_jax(header, breakers, tmp_path):
    def route(router_mod, workers_mod):
        seen = []

        def stub_http(method, url, body=None, raw=None, timeout=0, **kw):
            forwarded = (kw.get("headers") or {}).get(propagate.DEADLINE_HEADER)
            seen.append((url, sorted(kw), timeout <= 5.0,
                         forwarded is not None and 0 < float(forwarded) <= 5.0))
            return 202, {"id": "j", "state": "queued"}

        fleet = workers_mod.Fleet(str(tmp_path / router_mod.__name__),
                                  probe=lambda *a, **k: None)
        fleet.attach("http://wa.invalid", "wa")
        r = router_mod.RouterServer(fleet, port=0, http=stub_http,
                                    breakers=breakers)
        try:
            status, payload = r.route_submit(
                json.dumps({"width": 32, "height": 32}).encode(),
                deadline_header=header)
            counters = r.registry.snapshot()["counters"]
        finally:
            r.httpd.server_close()
        return status, payload, seen, counters

    assert route(router, workers) == route(jax_router, jax_workers)


# ---------------------------------------------------------------------------
# Retry budgets and backoff


def test_retry_budgets_match_jax():
    def run(mod):
        clock = _Clock()
        budget = mod.RetryBudget(capacity=2.0, refill_per_s=1.0, clock=clock)
        trace = [budget.try_take(), budget.try_take(), budget.try_take()]
        clock.now += 1.5
        trace += [budget.remaining(), budget.try_take(), budget.try_take()]
        clock.now += 100.0
        trace.append(budget.remaining())
        calls = []

        def fn():
            calls.append(1)
            raise ConnectionResetError("connection reset by peer")

        one = mod.RetryBudget(capacity=1.0, refill_per_s=0.0, clock=clock)
        with pytest.raises(ConnectionResetError):
            mod.RetryPolicy(attempts=5, base_delay=0.0).call(
                fn, budget=one, sleep=lambda s: None)
        trace.append(len(calls))
        for jitter, draw in ((0.5, 0.0), (0.5, 1.0), (0.0, 1.0)):
            sleeps = []
            with pytest.raises(ConnectionResetError):
                mod.RetryPolicy(attempts=3, base_delay=1.0, multiplier=2.0,
                                max_delay=8.0, jitter=jitter).call(
                    fn, sleep=sleeps.append, rng=lambda: draw)
            trace.append(sleeps)
        return trace

    assert run(retry) == run(jax_retry)


@pytest.mark.parametrize("cls, kwargs", [
    ("RetryBudget", {"capacity": 0}), ("RetryBudget", {"refill_per_s": -1}),
    ("RetryPolicy", {"jitter": 1.0}), ("RetryPolicy", {"jitter": -0.1}),
])
def test_retry_refusals_match_jax(cls, kwargs):
    errors = []
    for mod in (retry, jax_retry):
        with pytest.raises(ValueError) as err:
            getattr(mod, cls)(**kwargs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# The proxy


class _Echo(BaseHTTPRequestHandler):
    payload = json.dumps({"ok": True, "filler": "x" * 2048}).encode()

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(self.payload)))
        self.end_headers()
        self.wfile.write(self.payload)

    def log_message(self, *args):
        pass


@pytest.fixture
def upstream():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d" % httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


@pytest.mark.parametrize("spec", ["seed=3,refuse=0.3,latency=0.3,latency_ms=1",
                                  "seed=8,reset=0.4,truncate=0.2"])
def test_proxies_fault_the_same_exchanges(spec, upstream):
    def outcomes(mod):
        px = mod.ChaosProxy(upstream, mod.ChaosPlan.parse(spec))
        try:
            seen = []
            for _ in range(24):
                try:
                    status, _, body = client.http_exchange("GET", px.url + "/",
                                                           timeout=10)
                    seen.append((status, body == _Echo.payload))
                except (urllib.error.URLError, ConnectionError, OSError):
                    seen.append("connection trouble")
            return seen, px.stats()
        finally:
            px.close()

    class Port:
        ChaosProxy, ChaosPlan = proxy.ChaosProxy, plan.ChaosPlan

    class Jax:
        ChaosProxy, ChaosPlan = jax_proxy.ChaosProxy, jax_plan.ChaosPlan

    port, jax = outcomes(Port), outcomes(Jax)
    assert port == jax
    assert "connection trouble" in port[0]
