"""The SASS reader of the port's op count (gol_tpu_torch/tools/sass_ops.py),
on the CPU, on a hand-written dump in ``cuobjdump -sass``'s format."""

import pytest

from gol_tpu_torch.tools import sass_ops

_NAME = ("_ZN50_GLOBAL__N__c27a5370_17_stencil_packed_cu_ca65ba0e12bandt_kernelILNS_"
         "8FlagModeE{mode}ELNS_6SourceE{src}EEEvPKjS4_S4_S4_S4_PjPiiiii")


def _insn(addr: int, text: str) -> str:
    return (f"        /*{addr:04x}*/                   {text} ;"
            "                                        /* 0x000000000000 */\n"
            "                                                      /* 0x000000000000 */\n")


def _function(mode: int, src: int, loop: list[str], tail: list[str]) -> str:
    """One kernel: a prologue, a loop over ``loop`` closed by a predicated
    backward branch, and ``tail``."""
    lines = [f"\t\tFunction : {_NAME.format(mode=mode, src=src)}\n",
             '\t.headerflags\t@"EF_CUDA_SM90"\n']
    body = ["S2R R0, SR_TID.X", "SHFL.UP PT, R1, R2, 0x1, RZ"] + loop
    body += ["@!P2 BRA 0x20"] + tail + ["EXIT"]
    lines += [_insn(16 * i, t) for i, t in enumerate(body)]
    return "".join(lines)


def _sass(loop, tail=()):
    return "\n".join(_function(m, s, list(loop), list(tail))
                     for m, s in ((0, 0), (2, 0)))


# One level push, as the card runs it: two shuffles, two funnel shifts and
# ten 3-input LOP3s.
PUSH = (["SHFL.UP PT, R3, R4, 0x1, RZ", "SHFL.DOWN PT, R5, R4, 0x1, 0x1f",
         "SHF.L.W.U32.HI R3, R3, 0x1, R4", "SHF.R.W.U32 R5, R4, 0x1, R5"]
        + ["LOP3.LUT R6, R3, R5, R4, 0x96, !PT"] * 10)


def test_reads_the_steady_loop_per_word_and_generation():
    loop = PUSH * 4 + ["IMAD.MOV.U32 R7, RZ, RZ, R6", "@P0 BRA 0x400",
                       "ISETP.NE.AND P2, PT, R8, R9, PT"]
    r = sass_ops.analyse(_sass(loop))
    assert set(r) == {"summary, torus", "none, torus"}
    k = r["none, torus"]
    assert k["word_generations_per_iteration"] == 4
    assert k["logic_per_word_generation"] == 12
    assert k["network_logic_per_word_generation"] == 12
    assert k["per_word_generation"]["LOP3"] == 10
    assert k["per_word_generation"]["SHFL"] == 2
    # the loop's own branch and the forward one count as instructions
    assert k["loop_instructions"] == len(loop) + 1
    assert k["all_per_word_generation"] == (len(loop) + 1) / 4


def test_unconditional_and_divergence_branches_are_not_loops():
    # A slow path's return (BRA, unpredicated) and BRA.DIV jump back over
    # more shuffles than the loop holds; the loop is still the loop.
    tail = PUSH * 8 + ["BRA 0x0", "BRA.DIV UR4, 0x0"]
    r = sass_ops.analyse(_sass(PUSH * 2, tail))
    assert r["none, torus"]["word_generations_per_iteration"] == 2


def test_refuses_a_dump_without_the_kernel():
    with pytest.raises(RuntimeError, match="no bandt_kernel"):
        sass_ops.analyse("\t\tFunction : band_kernel\n" + _insn(0, "EXIT"))
    with pytest.raises(RuntimeError, match="no shuffle loop"):
        sass_ops.analyse(_sass([]).replace("@!P2 BRA 0x20", "NOP"))


def test_main_reads_a_saved_dump(tmp_path, capsys):
    path = tmp_path / "dump.sass"
    path.write_text(_sass(PUSH))
    out = tmp_path / "ops.json"
    assert sass_ops.main(["--sass", str(path), "--out", str(out)]) == 0
    assert out.read_text().strip() == capsys.readouterr().out.strip()
    assert sass_ops.main(["--sass", str(tmp_path / "missing")]) == 1
    assert capsys.readouterr().err.startswith("sass_ops: ")
