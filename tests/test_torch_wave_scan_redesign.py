"""The yardsticks of iterate_validate's and wave_commit's card cases, held
against the JAX oracles.

``chip_smoke.py`` holds the CUDA ``iterate_validate`` (a warp walks its
ops' intervals one after another, 128 rows a batch) and ``wave_commit``
(one cooperative launch; a lane wider than 1,024 ops spread over several
blocks) against their plain versions on ``chip_smoke.iterate_validate_cases``
and ``chip_smoke.wave_commit_cases``.  Here, on the CPU, the plain versions
meet ``ref.iterate_validate`` and ``ref.wave_commit`` (JAX) bit for bit on
exactly those cases, made with numpy from a seed, so the card compares
against a yardstick that is itself right; and the cases are shown to reach
each path of the new kernels: walks of one and of several batches, a
batch's and a warp's edges, lanes wider than a block, more work than one
co-resident grid holds.  The CUDA kernels run on the same cases in
tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.kernels.iterate_validate import scan_span

IV_CASES = chip_smoke.iterate_validate_cases()
WC_CASES = chip_smoke.wave_commit_cases()
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _t(x):
    if x is None:
        return None
    return torch.from_numpy(
        (x.view(np.int32) if x.dtype == np.uint32 else x).copy())


def _j(x):
    return None if x is None else jnp.asarray(x)


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _plain_verdicts(c):
    """The plain version's (conflict, commit) on a wave_commit case."""
    conflict, commit = K.wave_commit(
        *(_t(c[n]) for n in ("claim_w", "claim_r", "wts", "keys", "groups",
                             "prio", "do_w", "do_r", "check_w", "check_w2",
                             "check_r", "extra")),
        c["wave"], c["fine"], c["dual"], c["bump"])
    return conflict.numpy(), commit.numpy()


def _walked_rows(c):
    """Rows the kernel walks for each op that needs a walk (0 for the
    rest): min(width, span, N - start), as csrc/iterate_validate.cu."""
    N, G = c["table"].shape
    key = c["keys"].astype(np.int64)
    ext = np.maximum(c["extents"], 1).astype(np.int64)
    B = c["bucket_size"]
    if c["fine"]:
        start, width = key, ext
    else:
        start = (key // B) * B
        width = -(-(key + ext) // B) * B - start
    rows = np.minimum(np.minimum(width, scan_span(
        c["ext_cap"], c["fine"], B)), N - start)
    need = c["check"] & (key >= 0) & (rows > 0)
    if c["fine"]:
        need &= (c["groups"] >= 0) & (c["groups"] < G)
    return np.where(need, rows, 0)


@pytest.mark.parametrize("case", IV_CASES, ids=[c[0] for c in IV_CASES])
def test_iterate_validate_plain_matches_ref_on_card_cases(case):
    _, c = case
    want = np.asarray(ref.iterate_validate(
        *(jnp.asarray(c[n]) for n in ("table", "keys", "extents", "groups",
                                      "myprio", "check")),
        jnp.uint32(0xFFFF - (c["wave"] & 0xFFFF)), c["fine"],
        c["bucket_size"], c["ext_cap"]))
    got = K.iterate_validate(
        *(_t(c[n]) for n in ("table", "keys", "extents", "groups", "myprio",
                             "check")),
        c["wave"], c["fine"], c["bucket_size"], c["ext_cap"])
    np.testing.assert_array_equal(got.numpy(), want)
    # The planted claims: the last row of a span counts, a row past the
    # op's width does not.
    assert want.reshape(-1)[c["last_row_op"]]
    if c["past_width_op"] is not None:
        assert not want.reshape(-1)[c["past_width_op"]]
    assert want.any() and not want.all()
    assert K.iterate_validate.launches == 0


def test_iterate_validate_cases_reach_each_path():
    """Spans and walks at the warp's (32) and the batch's (128 rows)
    edges, walks of several batches, fine and coarse at B = 8 and 1, both
    halves of the claim tag, a warp of scans only and one with nothing to
    walk, and a planted row past the width in most cases."""
    warp = 32
    batch = warp * _constant("iterate_validate.cu", "kUnroll")
    assert batch == 128
    spans = {scan_span(c["ext_cap"], c["fine"], c["bucket_size"])
             for _, c in IV_CASES}
    assert {1, 31, 32, 33, 128, 129, 208} <= spans
    walked = np.concatenate([_walked_rows(c).reshape(-1)
                             for _, c in IV_CASES])
    assert {1, 31, 32, 33, 128, 129, 208} <= set(walked.tolist())
    assert walked.max() > batch
    modes = {(c["fine"], c["bucket_size"]) for _, c in IV_CASES}
    assert modes == {(True, 8), (True, 1), (False, 8), (False, 1)}
    widths = {(c["fine"], c["table"].shape[1]) for _, c in IV_CASES}
    assert widths == {(f, G) for f in (True, False) for G in (1, 2, 3)}
    tags = {(0xFFFF - (c["wave"] & 0xFFFF)) >> 15 for _, c in IV_CASES}
    assert tags == {0, 1}
    for _, c in IV_CASES:
        rows = _walked_rows(c)
        assert rows.shape[1] == warp          # one lane a warp
        if c["ext_cap"] > 1:
            # every op a scan
            assert (c["extents"][0] > 1).all() and (rows[0] > 0).all()
        assert (rows[1] == 0).all()           # nothing to walk
        assert (c["extents"][3] == 1).all() and (rows[3] > 0).all()
        assert (c["keys"][2] < 0).any() and (c["extents"][2] <= 0).any()
        N = c["table"].shape[0]
        assert (c["keys"][2] + c["extents"][2] > N).any()
    assert sum(c["past_width_op"] is not None for _, c in IV_CASES) >= 24


@pytest.mark.parametrize("case", WC_CASES, ids=[c[0] for c in WC_CASES])
def test_wave_commit_plain_matches_ref_on_card_cases(case):
    _, c = case
    dual, bump = c["dual"], c["bump"]
    cw, cr, wts, conflict, commit = ref.wave_commit(
        *(_j(c[n]) for n in ("claim_w", "claim_r", "wts", "keys", "groups",
                             "prio", "do_w", "do_r", "check_w", "check_w2",
                             "check_r", "extra")),
        jnp.uint32(c["wave"]), c["fine"], dual, bump)
    tabs = [_t(c[n]) for n in ("claim_w", "claim_r", "wts")]
    got_conflict, got_commit = K.wave_commit(
        *tabs, *(_t(c[n]) for n in ("keys", "groups", "prio", "do_w", "do_r",
                                    "check_w", "check_w2", "check_r",
                                    "extra")),
        c["wave"], c["fine"], dual, bump)
    np.testing.assert_array_equal(got_conflict.numpy(), np.asarray(conflict))
    np.testing.assert_array_equal(got_commit.numpy(), np.asarray(commit))
    np.testing.assert_array_equal(tabs[0].numpy().view(np.uint32),
                                  np.asarray(cw))
    if dual:
        np.testing.assert_array_equal(tabs[1].numpy().view(np.uint32),
                                      np.asarray(cr))
    if bump:
        np.testing.assert_array_equal(tabs[2].numpy().view(np.uint32),
                                      np.asarray(wts))
    assert K.wave_commit.launches == 0


def test_wave_commit_cases_reach_each_path():
    """K = 1, 33 and 1,024 (one block a lane); rows of 2,048, 16,384 and
    32,768 ops at T = 1 and 2 (several blocks a lane), one that commits
    and bumps and one whose only conflict is its last op; more units than
    any H100 holds at once, for blocks of one warp (K <= 32) and of
    kWideBlock threads; bump on and off, dual with every optional mask,
    no optional mask, both halves of the claim tag."""
    max_block = _constant("wave_commit.cu", "kMaxBlock")
    wide_block = _constant("wave_commit.cu", "kWideBlock")
    shapes = {c["keys"].shape for _, c in WC_CASES}
    assert {1, 33, max_block} <= {k for _, k in shapes}
    assert {(t, k) for t in (1, 2) for k in (2048, 16384, 32768)} <= shapes
    one_warp = chip_smoke.SM_BLOCKS * chip_smoke.H100_SMS
    wide_grid = chip_smoke.SM_THREADS // wide_block * chip_smoke.H100_SMS
    assert any(t > one_warp and k <= 32 for t, k in shapes)
    assert any(k > max_block and t * -(-k // wide_block) > wide_grid
               for t, k in shapes)
    wide = [c for _, c in WC_CASES if c["keys"].shape[1] > max_block]
    commits, lates = [], []
    for c in wide:
        conflict, commit = _plain_verdicts(c)
        commits.append(bool(commit.any()) and c["bump"])
        late = ~commit & ~conflict[:, :-1].any(1)
        lates.append(bool(late.any()))
    assert any(commits) and any(lates)
    flags = {(c["dual"], c["bump"], c["check_w2"] is not None,
              c["extra"] is not None) for _, c in WC_CASES}
    assert (True, True, True, True) in flags
    assert any(not b for _, b, _, _ in flags)
    assert any(not w2 and not x for _, _, w2, x in flags)
    assert {c["wave"] for _, c in WC_CASES} == {9, chip_smoke.HIGH_WAVE}
    assert any(c["fine"] for c in wide) and any(not c["fine"] for c in wide)
