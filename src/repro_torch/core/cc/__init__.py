"""Concurrency-control mechanisms, vectorized over a wave of transactions.

Each mechanism implements

    wave_validate(store, batch, prio, wave, cfg) -> (store, ValidationResult)

The port runs all eight: OCC, TicToc, 2PL, SwissTM, Adaptive, AutoGran
and the multi-version pair MVCC and MV-OCC.
"""
from repro_torch.core import types as _t
from repro_torch.core.cc.adaptive import wave_validate as adaptive_validate
from repro_torch.core.cc.autogran import wave_validate as autogran_validate
from repro_torch.core.cc.base import ValidationResult
from repro_torch.core.cc.mvcc import wave_validate as mvcc_validate
from repro_torch.core.cc.mvocc import wave_validate as mvocc_validate
from repro_torch.core.cc.occ import wave_validate as occ_validate
from repro_torch.core.cc.swisstm import wave_validate as swisstm_validate
from repro_torch.core.cc.tictoc import wave_validate as tictoc_validate
from repro_torch.core.cc.two_pl import wave_validate as two_pl_validate

VALIDATORS = {
    _t.CC_OCC: occ_validate,
    _t.CC_TICTOC: tictoc_validate,
    _t.CC_2PL: two_pl_validate,
    _t.CC_SWISS: swisstm_validate,
    _t.CC_ADAPTIVE: adaptive_validate,
    _t.CC_AUTOGRAN: autogran_validate,
    _t.CC_MVCC: mvcc_validate,
    _t.CC_MVOCC: mvocc_validate,
}

__all__ = ["ValidationResult", "VALIDATORS", "adaptive_validate",
           "autogran_validate", "mvcc_validate", "mvocc_validate",
           "occ_validate", "swisstm_validate", "tictoc_validate",
           "two_pl_validate"]
