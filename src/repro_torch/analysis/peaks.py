"""Hardware peak table: the one source of the roofline numbers (the twin
of the JAX package's ``analysis/peaks.py``, same table, same ridge).

One dict per chip: peak_flops (FLOP/s), hbm_bw (B/s) and link_bw (B/s,
one interconnect link).  The cost model (``analysis/txn_cost.py``) reads
these numbers.  ``ridge(chip)`` is the chip's arithmetic-intensity ridge
point (FLOP/byte): work below it is memory-bound, above it compute-bound.

The port's default chip is its card, the H100.  Its ``peak_flops`` is the
bf16 tensor-core peak, as in the JAX table, so the ridge is that of bf16
matmuls; the integer compares of the wave kernels run on the CUDA cores
(``chip_smoke.py`` bounds them with 67 Tops/s), which the ridge does not
model.
"""
from __future__ import annotations

HW_PEAKS = {
    # bf16 matmul peak, HBM stream, one ICI link.
    "tpu_v5e": {"peak_flops": 197e12, "hbm_bw": 819e9, "link_bw": 50e9},
    # A100 SXM 80G: bf16 tensor-core peak, HBM2e, one NVLink3 direction.
    "gpu_a100": {"peak_flops": 312e12, "hbm_bw": 2039e9, "link_bw": 300e9},
    # H100 SXM: bf16 tensor-core peak (dense), HBM3, one NVLink4 direction.
    "gpu_h100": {"peak_flops": 989e12, "hbm_bw": 3350e9, "link_bw": 450e9},
}

#: The port's card (every report that does not name a chip).
DEFAULT_CHIP = "gpu_h100"

PEAK_FLOPS = HW_PEAKS[DEFAULT_CHIP]["peak_flops"]
HBM_BW = HW_PEAKS[DEFAULT_CHIP]["hbm_bw"]
LINK_BW = HW_PEAKS[DEFAULT_CHIP]["link_bw"]


def ridge(chip: str = DEFAULT_CHIP) -> float:
    """Arithmetic-intensity ridge point (FLOP/byte) of ``chip``."""
    p = HW_PEAKS[chip]
    return p["peak_flops"] / p["hbm_bw"]
