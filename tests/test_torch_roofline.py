"""K14 and the port's roofline tool, on the CPU.

K14's plain version (``stencil_packed._bandt_noflags_plain``, what the
wrapper runs for a CPU tensor) against the JAX repo's
``_bandt_noflags_kernel`` (tools/roofline_r4.py) run through
``pl.pallas_call(..., interpret=True)`` with the JAX package's band
choice and banded specs, at zero tolerance; K14's words against K2's; and
the roofline tool's arithmetic (medians, rates, bounds, the flag-overhead
fraction, the tile's overfetch) from fixed times. The kernel itself and
the timings run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gol_tpu.ops import stencil_packed as jsp
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_packed as sp
from gol_tpu_torch.tools import roofline

_R4 = Path(__file__).resolve().parent.parent / "tools" / "roofline_r4.py"


@functools.lru_cache(maxsize=None)
def _roofline_r4():
    spec = importlib.util.spec_from_file_location("roofline_r4", _R4)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_noflags(words: np.ndarray) -> np.ndarray:
    """``_bandt_noflags_kernel`` as ``_step_t_noflags`` calls it, in
    interpret mode."""
    height, nwords = words.shape
    band = jsp._pick_band(height, nwords, jsp._bandt_target(height, nwords))
    out = pl.pallas_call(
        functools.partial(_roofline_r4()._bandt_noflags_kernel, band=band),
        grid=(height // band,),
        in_specs=jsp._banded_specs(band, nwords, height // jsp._SUBLANES),
        out_specs=pl.BlockSpec((band, nwords), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((height, nwords), jnp.uint32),
        interpret=True,
    )(*[jnp.asarray(words)] * 3)
    return np.asarray(out)


def _words(height, nwords, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (height, nwords), dtype=np.uint32)


@pytest.mark.parametrize("height,nwords", [(16, 2), (64, 4), (128, 8)])
def test_noflags_plain_matches_jax_kernel(height, nwords):
    words = _words(height, nwords, height + nwords)
    x = pm.words_from_numpy(words, "cpu")
    got = pm.words_to_numpy(sp._bandt_noflags_plain(x))
    np.testing.assert_array_equal(got, _jax_noflags(words))


@pytest.mark.parametrize("height,nwords", [(1, 1), (7, 1), (17, 5), (64, 4)])
def test_noflags_words_equal_k2_words(height, nwords):
    x = pm.words_from_numpy(_words(height, nwords, 7), "cpu")
    out = torch.empty_like(x)
    before = sp.LAUNCHES["bandt_noflags"]
    sp._step_t_noflags_into(x, out)
    assert sp.LAUNCHES["bandt_noflags"] == before  # the CPU path launches nothing
    assert torch.equal(out, sp._bandt_plain(x, exact=True)[0])
    assert torch.equal(sp._step_t_noflags(x), sp._step_t(x)[0])


def test_noflags_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="must not alias"):
        sp._step_t_noflags_into(x, x)
    with pytest.raises(ValueError, match="out must be int32"):
        sp._step_t_noflags_into(x, torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="2D int32"):
        sp._step_t_noflags_into(x.to(torch.int64), x)


def test_pass_bounds_from_shapes():
    # The ops bound at the network's 12 logic instructions (2 SHF, 10 LOP3),
    # and at packed_math's 28 two-input ops beside it.
    b = roofline.pass_bounds(16384, 512, 1.6727e13)
    assert b["bytes"] == 2 * 16384 * 512 * 4
    assert b["logic_ops"] == 8 * 16384 * 512 * 12
    assert b["bytes_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    assert b["ops_ms"] == pytest.approx(b["logic_ops"] / 1.6727e13 * 1e3)
    assert b["ops_ms_two_input"] == pytest.approx(8 * 16384 * 512 * 28 / 1.6727e13 * 1e3)
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops_ms"]
    slow_logic = roofline.pass_bounds(64, 2, 1e15)
    assert slow_logic["bound_by"] == "bytes"


@pytest.mark.parametrize("stdout, mhz", [("1980\n", 1980.0), ("[N/A]\n", None),
                                         ("", None)])
def test_sm_clock_reads_what_nvidia_smi_prints(monkeypatch, stdout, mhz):
    import subprocess

    monkeypatch.setattr(roofline.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, stdout, ""))
    assert roofline.sm_clock_mhz() == mhz


def test_summarize_from_fixed_times():
    times = {"K1": {"graph": [0.30, 0.29, 0.31], "profiler": [0.28, 0.28, 0.29]},
             "K2": {"graph": [0.29, 0.30, 0.28], "profiler": [0.27, 0.26, 0.27]},
             "K14": {"graph": [0.25, 0.20, 0.24], "profiler": [0.22, 0.21, 0.23]}}
    bounds = {"bound_ms": 0.1, "bound_by": "operations"}
    r = roofline.summarize(16384, times, bounds, (64, 32, 8))
    k1 = r["kernels"]["K1"]["graph"]
    assert k1["ms"] == 0.30 and k1["ms_reps"] == [0.30, 0.29, 0.31]
    assert k1["cell_updates_per_s"] == pytest.approx(16384 ** 2 * 8 / 0.30e-3)
    assert k1["share_of_bound"] == pytest.approx(0.1 / 0.30)
    assert r["kernels"]["K14"]["profiler"]["ms"] == 0.22
    # The JAX package's fraction: K14's rate over the flagged kernel's, - 1.
    assert r["flag_overhead_fraction"]["graph"] == pytest.approx(0.29 / 0.24 - 1)
    assert r["flag_overhead_fraction"]["profiler"] == pytest.approx(0.27 / 0.22 - 1)
    assert r["flag_overhead_fraction_k1"]["graph"] == pytest.approx(0.30 / 0.24 - 1)
    assert r["words"] == [16384, 512] and r["bound_by"] == "operations"
    assert r["tile_overfetch"] == ((64 + 16) / 64) * (34 / 32) == 1.328125


@pytest.mark.parametrize("exact", [False, True, None])
def test_check_holds_the_last_output_against_the_plain_version(exact):
    # exact None: K14 (words only); else K2 / K1 with their flags.
    rng = np.random.default_rng(5)
    x = pm.words_from_numpy(
        rng.integers(0, 1 << 32, (64, 4), dtype=np.uint32), torch.device("cpu"))
    if exact is None:
        plain = lambda w: (sp._bandt_noflags_plain(w), None)  # noqa: E731
    else:
        plain = lambda w: sp._bandt_plain(w, exact=exact)  # noqa: E731
    y, flags = plain(x)
    ok = roofline.check("K", x, y.clone(), flags, plain)
    assert ok == {"words": 256, "words_differing": 0, "flags_differing": 0}
    skipped = y.clone()
    skipped[:8, :2] = roofline.POISON  # one tile's corner never written
    with pytest.raises(RuntimeError, match="disagrees with its plain version"):
        roofline.check("K", x, skipped, flags, plain)
    if flags is not None:
        with pytest.raises(RuntimeError, match="'flags_differing': 1"):
            roofline.check("K", x, y, flags ^ (torch.arange(len(flags)) == 0),
                           plain)


def test_the_tool_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roofline.main(["--sizes", "64"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        roofline.main(["--sizes", "40"])
