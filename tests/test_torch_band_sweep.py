"""The host side of ``gol_tpu_torch.tools.band_sweep`` (no card, no nvcc):
the rewritten copies of the kernel source and the ptxas lines it reports,
and the ring order ``obs.profiler`` times it (and chip_smoke's K5) in."""

import pytest

from gol_tpu_torch.obs import profiler
from gol_tpu_torch.ops import _build
from gol_tpu_torch.tools import band_sweep

SOURCE = (_build.CSRC / "stencil_packed.cu").read_text()


@pytest.mark.parametrize("rows,ahead,blocks", [(4, 1, 1), (16, 2, 8), (64, 3, 12)])
def test_variant_source_rewrites_the_three_constants(rows, ahead, blocks):
    text = band_sweep.variant_source(SOURCE, rows, ahead, blocks)
    assert f"constexpr int kBandMinRows = {rows};" in text
    assert f"constexpr int kAhead = {ahead};" in text
    assert f"constexpr int kBandMinBlocks = {blocks};" in text
    changed = [(a, b) for a, b in zip(SOURCE.splitlines(), text.splitlines()) if a != b]
    assert len(text.splitlines()) == len(SOURCE.splitlines())
    assert len(changed) <= 3
    assert all(any(name in a for name in ("kBandMinRows", "kAhead", "kBandMinBlocks"))
               for a, _ in changed)


def test_variant_source_refuses_a_source_without_the_constants():
    with pytest.raises(RuntimeError, match="kBandMinRows"):
        band_sweep.variant_source("int main() {}", 16, 2, 1)


def test_registers_reads_band_kernel_lines_only():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111band_kernel"
        "ILi4ELNS_6SourceE0EEEvPKj' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_111band_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, used 0 barriers, 440 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112bandt_kernel"
        "ILNS_8FlagModeE0ELNS_6SourceE0EEEvPKj' for 'sm_90a'",
        "ptxas info    : Used 140 registers, used 0 barriers, 440 bytes cmem[0]",
    ])
    (line,) = band_sweep.registers(log)
    assert line.startswith("_ZN12_GLOBAL__N_111band_kernelILi4E")
    assert "0 bytes spill stores" in line and "Used 48 registers" in line


def test_run_ring_takes_the_shards_in_turn_and_runs_back():
    calls = []
    profiler.run_ring(lambda i, a, b: calls.append((i, a, b)),
                      ["x0", "x1", "x2"], ["y0", "y1", "y2"], 3)
    forth = [(0, "x0", "y0"), (1, "x1", "y1"), (2, "x2", "y2")]
    back = [(0, "y0", "x0"), (1, "y1", "x1"), (2, "y2", "x2")]
    assert calls == forth + back + forth


def test_the_tool_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert band_sweep.main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err
