"""Concurrency-control mechanisms, vectorized over a wave of transactions.

Each mechanism implements

    wave_validate(store, batch, prio, wave, cfg) -> (store, ValidationResult)

The port runs OCC and TicToc; ``VALIDATORS`` raises ``NotImplementedError``
for the others, naming the ROADMAP item they wait for.
"""
from repro_torch.core import types as _t
from repro_torch.core.cc.base import ValidationResult
from repro_torch.core.cc.occ import wave_validate as occ_validate
from repro_torch.core.cc.tictoc import wave_validate as tictoc_validate

_WAITS = {
    _t.CC_2PL: "ROADMAP A.3 (two_pl, with commit_install and claim_probe)",
    _t.CC_SWISS: "ROADMAP A.3 (swisstm)",
    _t.CC_ADAPTIVE: "ROADMAP A.3 (adaptive)",
    _t.CC_AUTOGRAN: "ROADMAP A.6 (AutoGran)",
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
})

__all__ = ["ValidationResult", "VALIDATORS", "occ_validate",
           "tictoc_validate"]
