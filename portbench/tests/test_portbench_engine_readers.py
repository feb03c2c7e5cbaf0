"""CPU tests of the engine's span and counter readers on synthetic
readings:

    python -m pytest portbench/tests -q

``engine.turnaround_ms_per_sim`` and ``engine.launch_ms_per_sim`` read the
program's ``engine.run`` spans of the window's simulations after the
profiled head, ``engine.readbacks_per_sim`` its readback counter; each
reads nothing from a program without them. The trace reduction names an
idle gap by the engine's ranges where the program opens them.
"""

import pytest

from portbench import devtrace, harness
from portbench.readings import Readings

SPAN_READERS = ("engine.turnaround_ms_per_sim", "engine.launch_ms_per_sim")
READERS = SPAN_READERS + ("engine.readbacks_per_sim",)


def _run(turnaround_ms, launch_ms):
    return {"name": "engine.run", "duration_s": 0.02,
            "attrs": {"blocks": 63, "readbacks": 64, "wait_s": 0.012,
                      "turnaround_s": turnaround_ms / 1e3,
                      "launch_s": launch_ms / 1e3}}


def _readings(spans, sims=4, traced=2, counters=None):
    return Readings(height=16384, width=16384, generations=[1000] * sims,
                    sim_s=[0.02] * sims, launches={"bandt_fast": 125 * sims},
                    counters=counters or {}, spans=spans, trace=None,
                    traced_sims=traced)


def _read(name, r):
    return harness.reader(name)(r)


def test_set_up_runs_and_the_profiled_head_are_left_out():
    # Two set-up calls and two profiled simulations, each far off the two
    # simulations after the head; a compile span in between.
    spans = [_run(100, 100), _run(100, 100), {"name": "engine.compile",
                                              "duration_s": 0.5},
             _run(50, 60), _run(50, 60), _run(2, 3), _run(4, 5)]
    r = _readings(spans, counters={"engine_readbacks_total": 256})
    assert _read("engine.turnaround_ms_per_sim", r) == pytest.approx(3.0)
    assert _read("engine.launch_ms_per_sim", r) == pytest.approx(4.0)
    assert _read("engine.readbacks_per_sim", r) == pytest.approx(64.0)


def test_a_ring_that_lost_its_oldest_spans_maps_to_the_last_simulations():
    # Six simulations, the first two profiled; the ring kept the last three
    # window spans only, all after the head.
    r = _readings([_run(2, 3), _run(4, 5), _run(6, 7)], sims=6)
    assert _read("engine.turnaround_ms_per_sim", r) == pytest.approx(4.0)
    assert _read("engine.launch_ms_per_sim", r) == pytest.approx(5.0)
    # Kept from inside the head: the profiled one is still left out.
    r = _readings([_run(50, 60), _run(2, 3), _run(4, 5)], sims=4)
    assert _read("engine.turnaround_ms_per_sim", r) == pytest.approx(3.0)
    # Kept from the head alone: nothing untraced to read.
    r = _readings([_run(50, 60)], sims=4, traced=4)
    assert _read("engine.turnaround_ms_per_sim", r) is None


def test_nothing_to_read_gives_none():
    compile_only = [{"name": "engine.compile", "duration_s": 0.5}]
    for r in (_readings([]), _readings(compile_only),
              _readings([_run(2, 3)] * 4, sims=0)):
        assert all(_read(m, r) is None for m in READERS)
    # Other counters moved, the readback counter did not exist.
    r = _readings(compile_only, counters={"engine_segments_total": 3})
    assert _read("engine.readbacks_per_sim", r) is None


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_an_idle_gap_inside_a_replay_is_named_by_it():
    # One simulation: a block's kernel, its readback's copy, 40 us of host
    # replay with the card idle, the next block's kernel.
    base = [
        _ev("user_annotation", "portbench.sim", 0, 200),
        _ev("kernel", "void bandt_kernel<1>(int)", 10, 60),
        _ev("cuda_runtime", "cudaMemcpyAsync", 60, 25),
        _ev("gpu_memcpy", "Memcpy DtoH", 70, 10),
        _ev("kernel", "void bandt_kernel<1>(int)", 130, 60),
    ]
    engine = [
        _ev("user_annotation", "engine.run", 5, 190),
        _ev("user_annotation", "engine.readback", 58, 30),
        _ev("user_annotation", "engine.replay", 90, 35),
        _ev("user_annotation", "engine.launch", 126, 6),
    ]
    before = dict(devtrace.reduce(base).idle_gaps)
    after = dict(devtrace.reduce(base + engine).idle_gaps)
    assert before["portbench.sim: python"] == pytest.approx(70e-6)
    assert after["engine.replay"] == pytest.approx(50e-6)
    assert after["engine.run"] == pytest.approx(20e-6)
    assert "portbench.sim: python" not in after
