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
    """Every kernel, every flag combination, hot/duplicate/masked
    ops, stale claim tags, scans across the table's end, rings that wrap
    and D = 1: chip_smoke's kernel phase raises on any difference."""
    N, _, T, K = shape
    checks, _ = chip_smoke.kernel_phase(
        _cuda(), {"case": shape},
        apply_shapes=(("apply_values", N, T, K, 4, 0),
                      ("apply_values_ring", N, T, K, 4, 4)))
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
    """Under scans the fused route bumps inside the phantom pass's
    iterate_validate launch, the unfused route through commit_install
    after it."""
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
def test_iterate_validate_edge_cases_bit_identical_to_plain_version():
    """The warp-cooperative walk on chip_smoke.iterate_validate_cases:
    walks at the warp's and the batch's edges, several batches, a claim in
    a span's last row and one past an interval's width."""
    check = chip_smoke.KernelCheck("iterate_validate")
    chip_smoke.iterate_validate_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.iterate_validate_cases())


@pytest.mark.cuda
def test_wave_commit_edge_cases_bit_identical_to_plain_version():
    """The one-launch wave on chip_smoke.wave_commit_cases: lanes of one
    op to 32,768, more lanes than one co-resident grid, one hot cell,
    masked keys and groups, every mask, bump on and off."""
    check = chip_smoke.KernelCheck("wave_commit")
    chip_smoke.wave_commit_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.wave_commit_cases())


@pytest.mark.cuda
def test_validate_pair_edge_cases_bit_identical_to_plain_version():
    """validate's one launch a multi-version wave on
    chip_smoke.validate_pair_cases: the waves' disjoint masks, overlapping
    masks, one channel alone, none; masked keys, groups past G, ties, both
    halves of the claim tag."""
    check = chip_smoke.KernelCheck("validate")
    chip_smoke.validate_pair_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.validate_pair_cases())


@pytest.mark.cuda
def test_validate_install_edge_cases_bit_identical_to_plain_version():
    """The multi-version wave's one launch (both claim installs, a grid
    barrier, the two-channel check) on chip_smoke.validate_install_cases:
    verdicts and both installed tables, ops with both, one or neither
    install and check, duplicate cells, and a wave of more ops than the
    co-resident grid has threads."""
    check = chip_smoke.KernelCheck("validate")
    chip_smoke.validate_install_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.validate_install_cases())


@pytest.mark.cuda
def test_mv_install_edge_cases_bit_identical_to_plain_version():
    """mv_install's one launch on chip_smoke.mv_install_cases: D = 1,
    heads outside [0, D), duplicate writers, masked keys and groups, and a
    wave past the kernel's one-op-a-thread capacity (its scratch vector)."""
    check = chip_smoke.KernelCheck("mv_install")
    chip_smoke.mv_install_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.mv_install_cases())


@pytest.mark.cuda
def test_mv_waves_launch_validate_and_mv_install_once_a_wave():
    """A local MVCC and MV-OCC run on the card: one validate launch (both
    claim installs and the check) and one mv_install launch a wave, no
    claim_scatter, and the plain route's state."""
    from repro_torch import kernels as K
    dev = _cuda()
    by, phases = chip_smoke.mv_path(
        dev, waves=6, lanes=16, tpcc_kw=dict(scale=0.01),
        ycsb_kw=dict(n_keys=2000, theta=0.9, write_frac=0.8, ro_frac=0.2))
    for ph in ("mv_mvcc", "mv_mvocc"):
        n, w = phases[ph]
        assert n["validate"] == w and n["mv_install"] == w
        assert n["claim_scatter"] == 0
    assert K.claim_scatter.launches == 0
    chip_smoke.cross_device(dev, waves=5, scale=0.01,
                            configs=(("mvcc", 0, True), ("mvocc", 1, True)))


@pytest.mark.cuda
def test_ts_install_forms_bit_identical_to_plain_version():
    """TicToc's three installs in one launch, the stamps computed in the
    kernel, on chip_smoke.ts_install_cases: both tables, masks empty and
    full, fine and coarse extensions, stamps past 2**32, and a wave past
    the resident grid."""
    check = chip_smoke.KernelCheck("ts_install_max")
    chip_smoke.ts_install_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.ts_install_cases())


@pytest.mark.cuda
def test_claim_probe_one_and_two_tables_bit_identical_to_plain_version():
    """claim_probe's one cooperative launch on one and two tables, on
    chip_smoke.claim_probe_cases: answers and installed tables, both tag
    halves, and a wave of more ops than the kernel's co-resident grid has
    threads."""
    check = chip_smoke.KernelCheck("claim_probe")
    chip_smoke.claim_probe_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.claim_probe_cases())


@pytest.mark.cuda
def test_tictoc_and_dual_unfused_waves_launch_once_a_wave():
    """A TicToc wave launches ts_install_max once; an unfused wave,
    dual (2PL, Adaptive) or not, launches claim_probe once; the routes
    end in the fused runs' results."""
    dev = _cuda()
    fused, launches = chip_smoke.main_path("tpcc", dev, waves=4, lanes=16,
                                           scale=0.01)
    assert launches["ts_install_max"] == 2 * 4
    chip_smoke.unfused_path(dev, fused, waves=4, lanes=16, scale=0.01)


@pytest.mark.cuda
def test_ts_gather_tictoc_form_bit_identical_to_plain_version():
    """TicToc's observation in one launch on chip_smoke.ts_gather_cases:
    commit_ts and ext_need, fine and coarse, lanes wider than the block,
    rts words whose + 1 wraps to 0."""
    check = chip_smoke.KernelCheck("ts_gather")
    chip_smoke.ts_gather_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.ts_gather_cases())


@pytest.mark.cuda
def test_ring_folds_bit_identical_to_plain_versions():
    """validate's and two-table claim_probe's ring reads on
    chip_smoke.ring_fold_cases: validate's verdicts and ok, claim_probe's
    verdict words, both installed tables, empty and reclaimed rings, a
    wave past the resident grid."""
    checks = {n: chip_smoke.KernelCheck(n) for n in ("validate",
                                                     "claim_probe")}
    chip_smoke.ring_fold_case_checks(checks, _cuda())
    torch.cuda.synchronize()
    for c in checks.values():
        assert c.equal and c.max_err == 0.0
        assert c.cases == len(chip_smoke.ring_fold_cases())


@pytest.mark.cuda
def test_tictoc_and_mv_waves_read_in_the_folded_launches():
    """A TicToc wave launches ts_gather once; a local MVCC or MV-OCC wave
    reads the ring inside validate, so mv_gather never launches; the
    backend op mv_gather still launches on its own."""
    dev = _cuda()
    _, launches = chip_smoke.main_path("tpcc", dev, waves=4, lanes=16,
                                       scale=0.01)
    assert launches["ts_gather"] == 2 * 4
    _, phases = chip_smoke.mv_path(
        dev, waves=6, lanes=16, tpcc_kw=dict(scale=0.01),
        ycsb_kw=dict(n_keys=2000, theta=0.9, write_frac=0.8, ro_frac=0.2))
    for ph in ("mv_mvcc", "mv_mvocc"):
        n, w = phases[ph]
        assert n["validate"] == w and n["mv_gather"] == 0
    shape = chip_smoke.SHAPES["tpcc"]
    try:
        chip_smoke.SHAPES["tpcc"] = (997, 2, 16, 64)
        launches = chip_smoke.backend_probe_path(dev)
    finally:
        chip_smoke.SHAPES["tpcc"] = shape
    assert launches["mv_gather"] == 1


@pytest.mark.cuda
def test_route_pack_edge_cases_bit_identical_to_plain_version():
    """The tiled pack on chip_smoke.route_pack_cases, both routes (direct
    and two-level), and a buffer of more than 2**31 words."""
    check = chip_smoke.KernelCheck("route_pack")
    chip_smoke.route_pack_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.route_pack_cases(huge=True))


@pytest.mark.cuda
def test_route_pack_refuses_more_destinations_than_the_kernel_takes():
    from repro_torch import kernels as K
    from repro_torch.kernels.route_pack import MAX_DESTINATIONS
    dev = _cuda()
    owner = torch.zeros((8,), dtype=torch.int32, device=dev)
    vals = torch.zeros((3, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="MAX_DESTINATIONS"):
        K.route_pack(owner, vals, MAX_DESTINATIONS + 1, 16, (0, 0, 0))


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


@pytest.mark.cuda
def test_apply_values_bit_identical_to_plain_replay():
    """The serial replay's kernel on chip_smoke.apply_values_cases at small
    shapes, bit for bit: flat, into a ring with the copy-forward
    (head_old), and past the one-launch form (160 x 64 ops: the grid
    form), every mode (signed priorities, negative columns and ring heads
    among them)."""
    from repro_torch.kernels.apply_values import route
    shapes = (("apply_values", 997, 16, 64, 4, 0),
              ("apply_values_ycsb", 4096, 128, 16, 10, 0),
              ("apply_values_ring", 997, 16, 64, 4, 4),
              ("apply_values_grid", 997, 160, 64, 4, 0))
    assert [route(T, K) for _, _, T, K, _, _ in shapes] == \
        ["block", "block", "block", "grid"]
    check = chip_smoke.KernelCheck("apply_values")
    chip_smoke.apply_values_checks(check, _cuda(), shapes)
    modes = {c[-1] for c in chip_smoke.apply_values_cases(shapes)}
    assert {"signed", "one_cell", "none"} <= modes
    assert check.equal and check.cases == len(
        chip_smoke.apply_values_cases(shapes))


@pytest.mark.cuda
def test_tracked_values_on_card():
    """Tracked runs: the card's values and ring values equal the CPU's
    from the same draws; tracked = untracked but for the values, one
    apply_values launch a wave (two under MVCC and MV-OCC), snapshot
    reads equal to the flat values of their wave; the tracked waves read
    nothing on the host."""
    dev = _cuda()
    chip_smoke.cross_device_values(dev, waves=5, scale=0.01)
    chip_smoke.values_path(
        dev, waves=8, lanes=16,
        sources={"tpcc": dict(scale=0.01),
                 "ycsb": dict(n_keys=2000, theta=0.9)})
    chip_smoke.sync_free_path(
        dev, lanes=16,
        configs=[c for c in chip_smoke.sync_free_configs() if c[-1]])


@pytest.mark.cuda
def test_sharded_open_loop_on_card():
    """The sharded open loop on a one-rank NCCL group: the identities,
    one launch of each kernel a wave, and the card equal to a gloo group
    on the CPU wave by wave."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import close_shards, init_shards
    dev = _cuda()
    shards = init_shards(dev)
    try:
        src = ("ycsb", dict(n_keys=5000, theta=0.9))
        chip_smoke.sharded_open_path(dev, waves=6, lanes=32, source=src)
        chip_smoke.sharded_open_cross_device(
            dev, cpu_group=dist.new_group(backend="gloo"), waves=4,
            lanes=32, source=src)
    finally:
        close_shards(shards)


@pytest.mark.cuda
def test_verdict_folds_bit_identical_to_plain_versions():
    """The sharded wave's folded verdict forms on
    chip_smoke.verdict_fold_cases against the chains they replace:
    wave_commit and claim_probe (one table; two with the ring) writing
    the packed words, iterate_validate ORing into bit 0 and bit 1,
    commit_install and mv_install reading commit words, the sender's
    gather forms; cap % 16 of 0 and 8, cap = 8, 1 to 8 rows, the one-card
    rows and a wave past the resident grid."""
    names = ("wave_commit", "claim_probe", "iterate_validate",
             "commit_install", "mv_install", "verdict_pack",
             "verdict_unpack")
    checks = {n: chip_smoke.KernelCheck(n) for n in names}
    chip_smoke.verdict_fold_case_checks(checks, _cuda())
    torch.cuda.synchronize()
    n = len(chip_smoke.verdict_fold_cases())
    for name, c in checks.items():
        assert c.equal and c.max_err == 0.0, name
        assert c.cases == (2 * n if name in ("claim_probe",
                                             "iterate_validate") else n)


@pytest.mark.cuda
def test_sharded_wave_packs_and_unpacks_once_a_wave_on_card():
    """A one-rank NCCL group at small sizes: every configuration launches
    verdict_pack and verdict_unpack once a wave (the sender's gather
    forms), the claim and install launches once a wave each, and matches
    the local validator (chip_smoke.sharded_path raises otherwise)."""
    from repro_torch.launch.mesh import close_shards, init_shards
    dev = _cuda()
    shards = init_shards(dev)
    try:
        sources = {
            "ycsb": ("ycsb", dict(n_keys=5000, theta=0.9)),
            "ycsb_e": ("ycsb", dict(n_keys=5000, theta=0.9, scan_frac=0.95,
                                    scan_len=16))}
        configs = {k: chip_smoke.DIST_CONFIGS[k] for k in sources}
        _, total, runs = chip_smoke.sharded_path(
            dev, waves=4, lanes=32, sources=sources, configs=configs)
    finally:
        close_shards(shards)
    assert total["verdict_pack"] == total["verdict_unpack"] == 4 * runs


@pytest.mark.cuda
def test_iterate_validate_bump_form_bit_identical_on_card_cases():
    """iterate_validate's bump form (a scan wave's phantom pass and its
    version bumps in one launch) against the chain it replaces on
    chip_smoke.bump_fold_cases: K = 1 to 1,030, every lane role, every
    write masked, wts words that wrap, a wave past the resident grid."""
    check = chip_smoke.KernelCheck("iterate_validate")
    chip_smoke.bump_fold_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.bump_fold_cases())


@pytest.mark.cuda
def test_validate_dual_install_form_bit_identical_on_card_cases():
    """validate_dual's install form (AutoGran's write-claim install and
    dual check in one cooperative launch) against claim_scatter_plain and
    validate_dual_plain on chip_smoke.dual_install_cases, the installed
    table too; the largest case strides past the resident grid."""
    check = chip_smoke.KernelCheck("validate_dual")
    chip_smoke.dual_install_case_checks(check, _cuda())
    torch.cuda.synchronize()
    assert check.equal and check.max_err == 0.0
    assert check.cases == len(chip_smoke.dual_install_cases())


#: Small cases of the language-model kernels: ragged lengths, GQA ratios
#: 1, 4 and 16, sk_valid < Sk and sq_valid < Sq, every head width, both
#: dtypes, decode (S = 1); and the bfloat16 tensor-core kernel's edges.
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
        *chip_smoke.FLASH_BF16_EDGE_CASES,
    ],
    "rglru": [
        ("bf16", dict(B=2, S=77, D=300), torch.bfloat16),
        ("S=1", dict(B=3, S=1, D=130), torch.float32),
        ("f32", dict(B=1, S=40, D=64), torch.float32),
        ("bf16 ragged tiles", dict(B=2, S=130, D=72), torch.bfloat16),
        ("log_a=0", dict(B=1, S=70, D=64, log_a="zero"), torch.bfloat16),
    ],
    "rwkv6": [
        ("bf16", dict(B=2, H=3, S=40, Dk=64, Dv=64), torch.bfloat16),
        ("S=1", dict(B=1, H=2, S=1, Dk=64, Dv=64), torch.float32),
        ("Dk16", dict(B=1, H=2, S=19, Dk=16, Dv=16), torch.float32),
        ("Dk32 Dv48", dict(B=1, H=1, S=8, Dk=32, Dv=48), torch.bfloat16),
        ("Dk128", dict(B=1, H=1, S=5, Dk=128, Dv=128), torch.float32),
        ("bf16 chunked", dict(B=1, H=2, S=130, Dk=64, Dv=64, decay="edge"),
         torch.bfloat16),
        ("bf16 chunked Dk128", dict(B=1, H=1, S=70, Dk=128, Dv=128,
                                    decay="model"), torch.bfloat16),
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


@pytest.mark.cuda
def test_waves_never_wait_on_the_host():
    """Two eager waves, then three under set_sync_debug_mode("error") and
    the profiler, with no host copy or sync among them
    (chip_smoke.sync_free_path raises otherwise): every mechanism fused,
    scans, the unfused route and the open step, tracked or not, at small
    sizes."""
    small = [("tpcc", dict(scale=0.01), cc, 1, True, 0.0, False)
             for cc in chip_smoke.ALL_CCS]
    small += [("tpcc", dict(scale=0.01, scan_len=16), cc, 0, True, 0.0,
               False) for cc in ("occ", "autogran", "mvcc")]
    small += [("tpcc", dict(scale=0.01), cc, 0, False, 0.0, False)
              for cc in ("occ", "2pl", "adaptive")]
    small += [("ycsb", dict(n_keys=2000), cc, 1, True, 12.0, track)
              for cc in ("occ", "mvcc") for track in (False, True)]
    small += [("tpcc", dict(scale=0.01), cc, 0, True, 0.0, True)
              for cc in ("occ", "tictoc")]
    launches, waves = chip_smoke.sync_free_path(_cuda(), lanes=16,
                                                configs=small)
    assert waves == 3 * len(small)
    assert launches["wave_commit"] > 0 and launches["validate"] > 0


@pytest.mark.cuda
def test_tracking_and_the_timeline_on_the_card(tmp_path):
    """Tracking off = on with three more launches a wave, a valid trace
    from txn_bench, and tracked runs on the card = the CPU
    (chip_smoke.observability_path and cross_device_observability raise
    otherwise), at small sizes."""
    launches, waves = chip_smoke.observability_path(
        _cuda(), waves=4, lanes=16, scale=0.01, out_dir=str(tmp_path))
    assert waves == 4 * (2 * len(chip_smoke.OBS_CONFIGS) + 4)
    assert launches["commit_install"] > 0
    chip_smoke.cross_device_observability(_cuda(), waves=3, scale=0.01)


@pytest.mark.cuda
def test_flash_attention_backward_matches_its_plain_version():
    """The backward kernel and the forward's lse against their plain
    versions at small shapes: causal GQA, a window with sk_valid, rows
    without keys, D 16 and 256, float32 and bf16, and the tensor-core
    route's edges; two calls give the same bits (flash_backward_phase
    raises otherwise), and the timed case's profile shows its four
    launches."""
    cases = (
        ("gqa causal", dict(B=1, Hq=8, Hkv=2, Sq=200, Sk=200, D=128,
                            causal=True, window=None), torch.bfloat16),
        ("window sk_valid", dict(B=2, Hq=4, Hkv=1, Sq=90, Sk=130, D=64,
                                 causal=True, window=40, sk_valid=120),
         torch.float32),
        ("rows without keys", dict(B=1, Hq=4, Hkv=1, Sq=70, Sk=130, D=32,
                                   causal=True, window=None, sq_valid=60,
                                   sk_valid=40), torch.bfloat16),
        ("D16", dict(B=1, Hq=2, Hkv=2, Sq=45, Sk=45, D=16, causal=False,
                     window=None), torch.float32),
        ("D256 rep16", dict(B=1, Hq=16, Hkv=1, Sq=100, Sk=100, D=256,
                            causal=True, window=50), torch.bfloat16),
        *chip_smoke.FLASH_BWD_BF16_EDGE_CASES,
    )
    worst, row = chip_smoke.flash_backward_phase(_cuda(), cases=cases)
    assert worst["cases"] == len(cases) and row["ms"] > 0
    assert set(row["split_ms"]) == {"delta", "dkdv", "rep sum", "dq"}


@pytest.mark.cuda
def test_recurrent_backwards_match_their_plain_versions():
    """rglru_backward and rwkv6_backward against their plain versions on
    every edge of chip_smoke's cases (all but the training shapes): a = 1
    exactly and log_a <= -20, S and D off the tiles, h0 / dh_last absent;
    w = 0, 1 and 1.9e-24, S = 1 to 4,097, Dk 16 to 128 with Dv != Dk,
    s0 / ds_last absent; float32 and bf16, both of rwkv6's routes; two
    calls give the same bits (recurrent_backward_phase raises
    otherwise)."""
    timed = ("rwkv6-3b-train",) + chip_smoke.RWKV_BWD_TIMED
    cases = {"rglru_backward": chip_smoke.RGLRU_BWD_CASES[1:],
             "rwkv6_backward": tuple(c for c in chip_smoke.RWKV_BWD_CASES
                                     if c[0] not in timed)}
    summary, timings = chip_smoke.recurrent_backward_phase(_cuda(),
                                                           cases=cases)
    for name, c in cases.items():
        assert summary[name]["cases"] == len(c) and timings[name]["ms"] > 0
    # rglru's backward keeps the plain version's operations: bit for bit.
    assert all(summary["rglru_backward"]["bit_identical"].values())
    # rwkv6's recurrent route walks dS back from ds_last as the plain
    # version does; the chunked route starts each chunk from its chain.
    routes = summary["rwkv6_backward"]["by_route"]
    assert set(routes) == {"chunked", "recurrent"}
    assert routes["recurrent"]["bit_identical"]["ds0"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-9b",
                                  "rwkv6-3b"])
def test_training_path_on_card(arch):
    """The training path on each family's smoke config: gradient gates,
    run_supervised's launch counts (every layer's kernel and its
    backward), the restart."""
    row, launches = chip_smoke.lm_train_path(_cuda(), arch, smoke=True,
                                             batch=4, seq=64)
    from repro_torch import configs
    ops = {op for lt in configs.get_smoke(arch).layer_types()
           for op in chip_smoke.LAYER_KERNELS[lt]}
    assert all(launches[op] > 0 for op in ops), launches
    assert row["restart"]["restore_bit_exact"]

