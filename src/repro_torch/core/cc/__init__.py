"""Concurrency-control mechanisms, vectorized over a wave of transactions.

Each mechanism implements

    wave_validate(store, batch, prio, wave, cfg) -> (store, ValidationResult)

The port runs OCC, TicToc, 2PL, SwissTM, Adaptive and AutoGran;
``VALIDATORS`` raises ``NotImplementedError`` for the multi-version pair,
naming the ROADMAP item they wait for.
"""
from repro_torch.core import types as _t
from repro_torch.core.cc.adaptive import wave_validate as adaptive_validate
from repro_torch.core.cc.autogran import wave_validate as autogran_validate
from repro_torch.core.cc.base import ValidationResult
from repro_torch.core.cc.occ import wave_validate as occ_validate
from repro_torch.core.cc.swisstm import wave_validate as swisstm_validate
from repro_torch.core.cc.tictoc import wave_validate as tictoc_validate
from repro_torch.core.cc.two_pl import wave_validate as two_pl_validate

_WAITS = {
    _t.CC_MVCC: "ROADMAP A.8 (multi-versioning)",
    _t.CC_MVOCC: "ROADMAP A.8 (multi-versioning)",
}


class _Validators(dict):
    """{cc: wave_validate}; a mechanism without a port raises on lookup."""

    def __missing__(self, cc):
        if cc in _WAITS:
            raise NotImplementedError(
                f"{_t.CC_NAMES[cc]} is not ported to repro_torch yet: it "
                f"waits for {_WAITS[cc]}")
        raise KeyError(cc)


VALIDATORS = _Validators({
    _t.CC_OCC: occ_validate,
    _t.CC_TICTOC: tictoc_validate,
    _t.CC_2PL: two_pl_validate,
    _t.CC_SWISS: swisstm_validate,
    _t.CC_ADAPTIVE: adaptive_validate,
    _t.CC_AUTOGRAN: autogran_validate,
})

__all__ = ["ValidationResult", "VALIDATORS", "adaptive_validate",
           "autogran_validate", "occ_validate", "swisstm_validate",
           "tictoc_validate", "two_pl_validate"]
