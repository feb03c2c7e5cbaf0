"""The host side of ``gol_tpu_torch.tools.batch_band_sweep`` (no card, no
nvcc): the rewritten copies of the kernel source, the ptxas lines it
reports and the band rows and tile widths it times."""

import pytest

from gol_tpu_torch.ops import _build
from gol_tpu_torch.tools import batch_band_sweep as sweep

SOURCE = (_build.CSRC / "stencil_batch.cu").read_text()


@pytest.mark.parametrize("packed,masked", [(1024, 1024), (512, 1024), (256, 512)])
def test_variant_source_rewrites_the_two_constants(packed, masked):
    text = sweep.variant_source(SOURCE, packed, masked)
    assert f"constexpr int kPackedBandThreads = {packed};" in text
    assert f"constexpr int kMaskedBandThreads = {masked};" in text
    changed = [(a, b) for a, b in zip(SOURCE.splitlines(), text.splitlines()) if a != b]
    assert len(text.splitlines()) == len(SOURCE.splitlines())
    assert len(changed) <= 2
    assert all(any(name in a for name in sweep._CONSTANTS) for a, _ in changed)


def test_the_shipped_source_holds_the_default_pair():
    """The tool's second default pair is the source's own constants."""
    assert sweep.variant_source(SOURCE, *sweep.THREADS[1]) == SOURCE


def test_variant_source_refuses_a_source_without_the_constants():
    with pytest.raises(RuntimeError, match="kPackedBandThreads"):
        sweep.variant_source("int main() {}", 512, 1024)


def test_registers_reads_the_banded_kernels_lines_only():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__8c9fbc89_16_"
        "stencil_batch_cu_1d0bc02424batch_packed_band_kernelEPKjPjPiPKiiiiiii' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN49_GLOBAL__N_batch_packed_band",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 55 registers, used 1 barriers, 256 bytes smem",
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__8c9fbc89_16_"
        "stencil_batch_cu_1d0bc02425batch_packed_block_kernelEPKjPjPiPKiiiiii' "
        "for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 1 barriers, 256 bytes smem",
    ])
    (line,) = sweep.registers(log)
    assert line.startswith("batch_packed_band_kernel: ")
    assert "0 bytes spill stores" in line and "Used 55 registers" in line


def test_registers_names_the_templates_forms():
    """The banded kernels are templates: false is the banded form, true the
    column-cut form."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__8c9fbc89_16_"
        "stencil_batch_cu_1d0bc02424batch_masked_band_kernelILb1EEvPKhPhPiPKiS5_"
        "S5_iiiiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 61 registers, used 1 barriers, 256 bytes smem",
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__8c9fbc89_16_"
        "stencil_batch_cu_1d0bc02424batch_packed_band_kernelILb0EEvPKjPjPiPKiiiiiiiii' "
        "for 'sm_90a'",
        "ptxas info    : Used 55 registers, used 1 barriers, 256 bytes smem",
    ])
    masked, packed = sweep.registers(log)
    assert masked.startswith("batch_masked_band_kernel<true>: ")
    assert "Used 61 registers" in masked
    assert packed.startswith("batch_packed_band_kernel<false>: ")


@pytest.mark.parametrize("plan,want", [(605, [302, 605]), (35, [17, 35]),
                                       (1, [1, 2])])
def test_tile_words_are_half_the_plan_and_twice_where_they_fit(plan, want):
    """A tile of a 32-row board's whole height holds 32 rows: 2 x 605 + 2
    words a row pass 29,024 words a copy; tiles of 631 rows hold 663 with
    their ghost rows, of up to 41 words."""
    rows = 32 if plan != 35 else 631
    height = 32 if plan != 35 else 16384
    assert sweep.tile_words(plan, rows, height, 9675 if plan != 35 else 512,
                            29024) == want


@pytest.mark.parametrize("plan,want", [(512, [256, 512]), (64, [32, 64, 128]),
                                       (16, [8, 16, 32]), (1, [1, 2])])
def test_band_rows_are_half_the_plan_and_twice_where_they_fit(plan, want):
    """An H100's 29,024 words a copy hold 907 rows of 32 words: R + 32 ghost
    rows fit up to R = 875, so 2 x 512 is left out."""
    assert sweep.band_rows(plan, 1024, 32, 29024) == want


def test_the_tool_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert sweep.main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err
