"""Card-only checks of the benchmark's pieces. They skip without a card;
on the card:

    python -m pytest --noconftest -m cuda portbench/tests -q
"""

import pytest
import torch

from portbench.reference import life


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("torus", [True, False])
def test_word_form_matches_byte_form_on_the_card(torus):
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cells = (torch.rand((1024, 2048), generator=gen, device=dev) < 0.5).to(torch.uint8)
    words, on_cpu = life.pack(cells), cells.cpu()
    for _ in range(40):
        cells = life.step_bytes(cells, torus)
        on_cpu = life.step_bytes(on_cpu, torus)
        words = life.step_words(words, torus)
    assert life.wrong_cells(words, cells) == 0
    assert torch.equal(cells.cpu(), on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g16k-soup-c", "g16k-soup-cuda"])
def test_a_small_cell_on_the_card_is_correct_and_its_control_is_not(
        monkeypatch, name):
    from portbench import control, harness

    _card()
    real = harness.config
    # Every settling pattern exits within 300 generations.
    monkeypatch.setattr(harness, "config", lambda bench, cfg: dict(
        real(bench, cfg), width=2048, height=1024, gen_limit=300))
    bench = harness.load_benchmark()
    cell = harness.workload(bench, name)
    line = harness.run_cell(bench, cell, seed=2**31 + 9, seconds=4.0,
                            trace=True)
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["kernels.roofline_share"]["value"] <= 100
    assert line["metrics"]["ops.launches_per_sim"]["value"] > 0
    assert line["metrics"]["engine.idle_ms_per_sim"]["value"] > 0
    line = harness.run_cell(bench, cell, seed=5, seconds=1.0, trace=False,
                            make_runner=control.control_runner)
    assert line["correct"] is False
    line = harness.run_cell(bench, cell, seed=6, seconds=1.0, trace=False,
                            make_runner=control.no_similarity_runner)
    assert line["correct"] is False
    assert line["check"]["settle_counts_wrong"]["value"] > 0
