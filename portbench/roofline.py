"""The least time a simulation could take on one NVIDIA H100, from its
shape and the published peaks, frozen here so that no run reads them from
the card.

The work counted is what the problem needs, whatever kernel does it: each
generation updates every cell once, 32 cells a 32-bit word, with
``OPS_PER_WORD_GEN`` integer logic instructions per word (the adder
network of two funnel shifts, four sums and six rule instructions, as
``gol_tpu_torch/tools/roofline.py`` counts it), and the uint8 grid is read
once and written once. Launches, passes, flags and replays are not work
the problem needs, and are not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (H100 80GB HBM3): 132 SMs at the 1980 MHz maximum SM
# clock; 64 results of 32-bit integer logic per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0); 3.35 TB/s of HBM3 (NVIDIA's data sheet).
SMS = 132
SM_CLOCK_HZ = 1.98e9
INT32_LOGIC_PER_CLK_PER_SM = 64
LOGIC_OPS_PER_S = INT32_LOGIC_PER_CLK_PER_SM * SMS * SM_CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
CELLS_PER_WORD = 32
OPS_PER_WORD_GEN = 12


def least_seconds(height: int, width: int, generations: int) -> tuple[float, str]:
    """``(seconds, bound)``: the larger of the operations' time and the
    bytes' time of one simulation of ``generations`` generations, and which
    of the two it is."""
    words = height * width / CELLS_PER_WORD
    ops_s = words * generations * OPS_PER_WORD_GEN / LOGIC_OPS_PER_S
    bytes_s = 2 * height * width / HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
