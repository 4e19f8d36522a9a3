"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU host that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where torch.cuda.is_available()
is False (CUDA kernels have no CPU mode).
"""
import pytest
import torch

import chip_smoke


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(997, 2, 16, 64), (4096, 2, 128, 16),
                                   (50, 1, 3, 5)],
                         ids=["tpcc-like", "ycsb-like", "ragged"])
def test_kernels_bit_identical_to_plain_versions(shape):
    """All twelve kernels, every flag combination, hot/duplicate/masked
    ops, stale claim tags, scans across the table's end, rings that wrap
    and D = 1: chip_smoke's kernel phase raises on any difference."""
    checks, _ = chip_smoke.kernel_phase(_cuda(), {"case": shape})
    assert set(checks) == set(chip_smoke.KERNEL_META)
    for c in checks.values():
        assert c.equal and c.max_err == 0.0 and c.cases > 0, c.name


@pytest.mark.cuda
def test_wave_step_identical_on_card_and_cpu():
    """Every mechanism and the unfused route, heats and mode bits too."""
    chip_smoke.cross_device(_cuda(), waves=5, scale=0.01)


@pytest.mark.cuda
def test_fused_and_unfused_routes_identical_on_card():
    """claim_probe + commit_install against wave_commit, on one mechanism
    that runs both claim tables and bumps."""
    chip_smoke.fused_unfused(_cuda(), waves=5, scale=0.01,
                             ccs=(("adaptive", 0),))


@pytest.mark.cuda
def test_wave_step_with_scans_and_rings_identical_on_card_and_cpu():
    """One scan configuration per mechanism (TPC-C's scan classes), the
    version ring included."""
    chip_smoke.cross_device(_cuda(), waves=5, scale=0.01, scan_len=16,
                            configs=chip_smoke.SCAN_CONFIGS)


@pytest.mark.cuda
def test_padded_and_open_loop_steps_identical_on_card_and_cpu():
    """A sweep point below its bucket maximum (96 of 128 lanes) and an
    open-loop configuration (queue, counters, histogram)."""
    dev = _cuda()
    chip_smoke.cross_device_padded(dev, waves=5, scale=0.01)
    chip_smoke.cross_device_open(dev, waves=5, n_keys=2000)


@pytest.mark.cuda
def test_fused_and_unfused_routes_identical_with_scans_on_card():
    """Under scans the fused route bumps through commit_install after the
    phantom pass."""
    chip_smoke.fused_unfused(_cuda(), waves=5, scale=0.01,
                             ccs=(("occ", 0), ("2pl", 1)), scan_len=16)


@pytest.mark.cuda
def test_mv_install_resolves_every_op_on_one_record():
    """Every op of the wave on one record, in both groups, and a head at
    D-1: one new slot, both groups stamped, as the plain version."""
    from repro_torch import kernels as K
    from repro_torch.core.mvstore import mv_init
    from repro_torch.kernels.mv_install import mv_install_plain
    dev = _cuda()
    begin, head, _ = mv_init(64, 4, 2, dev)
    head[7] = 3
    keys = torch.full((128, 16), 7, dtype=torch.int32, device=dev)
    groups = (torch.arange(128 * 16, device=dev) % 2).to(
        torch.int32).view(128, 16)
    do = torch.ones((128, 16), dtype=torch.bool, device=dev)
    a, b = (begin.clone(), head.clone()), (begin.clone(), head.clone())
    K.mv_install(*a, keys, groups, do, 5)
    mv_install_plain(*b, keys, groups, do, 5)
    torch.cuda.synchronize(dev)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[1][7]) == 0 and a[0][7, 0].tolist() == [5, 5]


@pytest.mark.cuda
def test_sharded_wave_kernels_bit_identical_to_plain_versions():
    """route_pack (1 and 8 destinations, drops, skew, masked owners),
    verdict_pack / verdict_unpack (ragged rows, bit 31) and wave_commit on
    rows of 4,096 ops, at 64 lanes of 16 slots."""
    names = ("route_pack", "verdict_pack", "verdict_unpack", "wave_commit")
    checks = {n: chip_smoke.KernelCheck(n) for n in names}
    chip_smoke.dist_kernel_checks(checks, _cuda(), lanes=64)
    for c in checks.values():
        assert c.equal and c.max_err == 0.0 and c.cases > 0, c.name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096), (3, 2500), (2, 1025)])
def test_wave_commit_takes_rows_wider_than_1024_ops(shape):
    from repro_torch import kernels as K
    from repro_torch.kernels.wave_commit import wave_commit_plain
    dev = _cuda()
    T, Kk = shape
    cw0, cr0, wts0, _ = chip_smoke.make_tables(5000, 2, 3, dev, seed=1)
    keys, groups, prio, masks = chip_smoke._wide_ops(5000, 2, T, Kk, dev, 2)
    do_w, do_r, check_w, check_w2, check_r, extra = masks
    outs = []
    for fn in (K.wave_commit, wave_commit_plain):
        cw, cr, wt = cw0.clone(), cr0.clone(), wts0.clone()
        outs.append(fn(cw, cr, wt, keys, groups, prio, do_w, do_r, check_w,
                       check_w2, check_r, extra, 3, False, True, True)
                    + (cw, cr, wt))
    torch.cuda.synchronize(dev)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sharded_wave_identical_on_card_and_cpu():
    """A one-rank NCCL group on the card against a gloo group on the CPU,
    at small sizes: commit masks, tables and stats bit-identical."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import close_shards, init_shards
    dev = _cuda()
    shards = init_shards(dev)
    try:
        sources = {
            "ycsb": ("ycsb", dict(n_keys=5000, theta=0.9)),
            "tpcc": ("tpcc", dict(scale=0.01)),
            "ycsb_e": ("ycsb", dict(n_keys=5000, theta=0.9, scan_frac=0.95,
                                    scan_len=16))}
        chip_smoke.sharded_cross_device(
            dev, cpu_group=dist.new_group(backend="gloo"), waves=4,
            lanes=32, sources=sources)
    finally:
        close_shards(shards)


#: Small cases of the language-model kernels: ragged lengths, GQA ratios
#: 1, 4 and 16, sk_valid < Sk and sq_valid < Sq, every head width, both
#: dtypes, decode (S = 1).
LM_SMALL_CASES = {
    "flash_attention": [
        ("window rep16", dict(B=1, Hq=16, Hkv=1, Sq=200, Sk=200, D=256,
                              causal=True, window=70), torch.bfloat16),
        ("S=1", dict(B=2, Hq=4, Hkv=1, Sq=1, Sk=130, D=128, causal=False,
                     window=None), torch.bfloat16),
        ("valid", dict(B=2, Hq=8, Hkv=2, Sq=50, Sk=150, D=64, causal=True,
                       window=40, sq_valid=45, sk_valid=120),
         torch.float32),
        ("rep1 full", dict(B=1, Hq=2, Hkv=2, Sq=65, Sk=65, D=32,
                           causal=False, window=None), torch.float32),
        ("D16", dict(B=1, Hq=2, Hkv=1, Sq=31, Sk=31, D=16, causal=True,
                     window=None), torch.bfloat16),
    ],
    "rglru": [
        ("bf16", dict(B=2, S=77, D=300), torch.bfloat16),
        ("S=1", dict(B=3, S=1, D=130), torch.float32),
        ("f32", dict(B=1, S=40, D=64), torch.float32),
    ],
    "rwkv6": [
        ("bf16", dict(B=2, H=3, S=40, Dk=64, Dv=64), torch.bfloat16),
        ("S=1", dict(B=1, H=2, S=1, Dk=64, Dv=64), torch.float32),
        ("Dk16", dict(B=1, H=2, S=19, Dk=16, Dv=16), torch.float32),
        ("Dk32 Dv48", dict(B=1, H=1, S=8, Dk=32, Dv=48), torch.bfloat16),
        ("Dk128", dict(B=1, H=1, S=5, Dk=128, Dv=128), torch.float32),
    ],
}


@pytest.mark.cuda
def test_lm_kernels_match_their_plain_versions():
    """flash_attention, rglru and rwkv6 against their plain versions:
    float32 within rtol 1e-5 / atol 1e-5, bfloat16 within 2 ulps
    (chip_smoke.LMCheck raises otherwise)."""
    checks, timings = chip_smoke.lm_kernel_phase(_cuda(),
                                                 cases=LM_SMALL_CASES)
    for name, c in checks.items():
        assert c.cases == len(LM_SMALL_CASES[name]), name
        assert c.max_ulps <= 2, name
    assert timings["flash_attention"]["library_ms"] is not None


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_lm_serving_launches_its_kernels_and_matches_the_plain_route(arch):
    """The smoke configuration (float32) served on the card: exactly one
    launch per recurrent layer per step and per attention layer in the
    prefill, and the kernel route's logits within relative L2 1e-2 of the
    plain route's (chip_smoke.lm_serve_path raises otherwise)."""
    row, launches = chip_smoke.lm_serve_path(
        _cuda(), arch, smoke=True, n_requests=2, prompt_len=40, gen=4)
    assert sum(launches.values()) > 0
    for step in ("prefill", "decode"):
        errs = row["route_rel_l2"][step]
        assert errs["f32 kernel vs plain"] <= chip_smoke.LM_ROUTE_RTOL
        assert errs["bf16 kernel vs plain"] <= chip_smoke.LM_ROUTE_RTOL
