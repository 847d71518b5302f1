"""Parity of the port's pure-Python selection substrate with the JAX package.

Partitions, op keys, Bloom/sieve bytes, cost-model rankings and selector
picks involve no floating-point kernels, so the two packages must agree
EXACTLY (tolerance 0): the port's modules are copies, and any drift is a
porting fault. Also checks that the Hopper tile set gives the nominal H100
machine at least one feasible tile for every fingerprint of the served slice.
"""

import numpy as np
import pytest

from repro.configs.gemm_suite import suite
from repro.core import bloom as jb
from repro.core import costmodel as jcm
from repro.core import op as jop
from repro.core import opensieve as josv
from repro.core import policies as jpol
from repro.core import selector as jsel
from repro.core import tuner as jtun
from repro.core import workpart as jwp
from repro_torch.core import bloom as tb
from repro_torch.core import costmodel as tcm
from repro_torch.core import op as top
from repro_torch.core import opensieve as tosv
from repro_torch.core import policies as tpol
from repro_torch.core import selector as tsel
from repro_torch.core import tuner as ttun
from repro_torch.core import workpart as twp

SUITE_SAMPLE = suite()[::41]  # 23 sizes spread over the 923-size suite
TPU_TILES = [(8, 128, 128), (128, 128, 128), (256, 512, 128), (8, 256, 1024)]


def _part_tuple(p):
    return (
        p.m_tiles, p.n_tiles, p.iters_per_tile, p.sk_tiles,
        tuple((r.wg, r.start, r.end) for r in p.sk_ranges),
        tuple((c.tile, c.first_wg, c.last_wg) for c in p.contributions),
    )


@pytest.mark.parametrize("pol_name", [p.name for p in jpol.ALL_POLICIES])
def test_partitions_match_on_suite_sample(pol_name):
    jp, tp = jpol.policy_from_name(pol_name), tpol.policy_from_name(pol_name)
    for m, n, k in SUITE_SAMPLE:
        for tile in TPU_TILES:
            for g in (4, 8, 16):
                want = jwp.partition(jwp.GemmShape(m, n, k), jpol.TileConfig(*tile), g, jp)
                got = twp.partition(twp.GemmShape(m, n, k), tpol.TileConfig(*tile), g, tp)
                assert _part_tuple(got) == _part_tuple(want)
                js = jwp.partition_stats(jwp.GemmShape(m, n, k), jpol.TileConfig(*tile), g, jp)
                ts = twp.partition_stats(twp.GemmShape(m, n, k), tpol.TileConfig(*tile), g, tp)
                assert vars(ts) == vars(js)


OP_CASES = [
    dict(m=64, n=4096, k=4096),
    dict(m=4, n=14336, k=4096, in_dtype="bfloat16", epilogue=("none", False, "mul_silu")),
    dict(m=17, n=300, k=200, in_dtype="float32", epilogue=("gelu", True, "none")),
    dict(m=8, n=1024, k=4096, in_dtype="bfloat16", out_dtype="float32"),
    dict(m=32, n=512, k=256, divisors=(2, 4, 1), epilogue=("relu", False, "add")),
]


def _ops(case, mod_op):
    kw = dict(case)
    epi = kw.pop("epilogue", None)
    m, n, k = kw.pop("m"), kw.pop("n"), kw.pop("k")
    if epi is not None:
        kw["epilogue"] = mod_op.Epilogue(activation=epi[0], bias=epi[1], binary=epi[2])
    return mod_op.GemmOp.plain(m, n, k, **kw)


@pytest.mark.parametrize("case", OP_CASES, ids=lambda c: "x".join(str(c[d]) for d in "mnk"))
def test_gemm_op_keys_and_bytes_match(case):
    jo, to = _ops(case, jop), _ops(case, top)
    assert to.key == jo.key
    assert to.encode() == jo.encode()
    assert top.key_to_str(to.key) == jop.key_to_str(jo.key)
    assert top.key_from_str(top.key_to_str(to.key)) == jop.key_from_str(jop.key_to_str(jo.key))
    grouped = dict(m=8, n=256, k=128, g=4, kind="grouped", in_dtype="bfloat16",
                   out_dtype="bfloat16", fused=True)
    assert top.GemmOp(**grouped).encode() == jop.GemmOp(**grouped).encode()


def test_bloom_and_sieve_bytes_match():
    for data, seed in ((b"", 0), (b"hello", 0), (b"Stream-K++", 0x9747B28C)):
        assert tb.murmur3_32(data, seed) == jb.murmur3_32(data, seed)
    jf, tf = jb.BloomFilter.for_capacity(500, 0.01, seed=3), tb.BloomFilter.for_capacity(500, 0.01, seed=3)
    for m, n, k in SUITE_SAMPLE:
        jf.add_mnk(m, n, k)
        tf.add_mnk(m, n, k)
    assert tf.to_bytes() == jf.to_bytes()
    rng = np.random.default_rng(0)
    winners = {s: int(rng.integers(len(jpol.ALL_POLICIES))) for s in SUITE_SAMPLE}
    js = josv.OpenSieve(capacity=200).build_from_winners(
        {s: jpol.ALL_POLICIES[i] for s, i in winners.items()})
    ts = tosv.OpenSieve(capacity=200).build_from_winners(
        {s: tpol.ALL_POLICIES[i] for s, i in winners.items()})
    assert ts.to_bytes() == js.to_bytes()
    assert ts.encode_cpp_header() == js.encode_cpp_header()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rank_candidates_match_under_v5e(dtype):
    jdt, tdt = jcm.profile_for(dtype), tcm.profile_for(dtype)
    for m, n, k in SUITE_SAMPLE:
        want = jcm.rank_candidates(jwp.GemmShape(m, n, k), jcm.V5E, dt=jdt)
        got = tcm.rank_candidates(twp.GemmShape(m, n, k), tcm.V5E, dt=tdt)
        assert [(p.name, c.name, g, t) for p, c, g, t in got] == [
            (p.name, c.name, g, t) for p, c, g, t in want
        ]


def _sel_tuple(s):
    return (s.policy.name, s.cfg.name, s.g, s.source, s.evals, s.pruned)


def _records(mod_tun, mod_cm, mod_wp):
    """The same tuning records in either package: the V5E model's winner
    for half of the sample, keyed on the bare (M, N, K)."""
    recs = []
    for m, n, k in SUITE_SAMPLE[::2]:
        ranked = mod_cm.rank_candidates(mod_wp.GemmShape(m, n, k), mod_cm.V5E)
        pol, cfg, g, t = ranked[0]
        runner = next(p for p, *_ in ranked if p != pol)
        recs.append(mod_tun.TuningRecord(
            size=(m, n, k), policy=pol.name, cfg=cfg.name, tflops=1.0 / t,
            runner_up_policy=runner.name, runner_up_tflops=0.5 / t,
            dp_best_tflops=0.25 / t, g=g, version=1, wall=1.0,
        ))
    return recs


@pytest.mark.parametrize("artifacts", ["none", "sieve", "db+sieve"])
def test_selections_match(artifacts):
    def build(mod_sel, mod_tun, mod_cm, mod_wp):
        db = mod_tun.TuningDatabase()
        for rec in _records(mod_tun, mod_cm, mod_wp):
            db.add_record(rec, stamp=False)
        if artifacts == "none":
            state = mod_sel.SelectorState()
        elif artifacts == "sieve":
            state = mod_sel.SelectorState(sieve=db.build_sieve(capacity=500))
        else:
            state = mod_sel.SelectorState(db=db, sieve=db.build_sieve(capacity=500))
        return mod_sel.KernelSelector(state=state)

    js = build(jsel, jtun, jcm, jwp)
    ts = build(tsel, ttun, tcm, twp)
    for m, n, k in SUITE_SAMPLE:
        for dtype in ("float32", "bfloat16"):
            jo = jop.GemmOp.plain(m, n, k, in_dtype=dtype)
            to = top.GemmOp.plain(m, n, k, in_dtype=dtype)
            assert _sel_tuple(ts.select_op(to)) == _sel_tuple(js.select_op(jo))
    jstats = dict(vars(js.stats))
    # without a calibration neither selector dispatches from "model"
    assert jstats["model_warm"] == 0
    assert vars(ts.stats) == jstats


SLICE_NK = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (49152, 4096)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_slice_fingerprint_ranks_under_h100(dtype):
    """granite-8b's projections at decode and prompt widths: the nominal
    H100 with the Hopper tile set finds a feasible tile for each, and the
    default CUDA selector picks from that set."""
    sel = tsel.default_selector("cuda")
    assert sel.mach == tcm.H100 and sel.tile_configs == tpol.HOPPER_TILE_CONFIGS
    dt = tcm.profile_for(dtype)
    for m in (1, 4, 16, 33, 64, 256):
        for n, k in SLICE_NK:
            ranked = tcm.rank_candidates(
                twp.GemmShape(m, n, k), tcm.H100, tile_configs=tpol.HOPPER_TILE_CONFIGS, dt=dt
            )
            assert ranked
            for epi in (None, top.Epilogue(binary="mul_silu")):
                s = sel.select_op(top.GemmOp.plain(m, n, k, in_dtype=dtype, epilogue=epi))
                assert s.cfg in tpol.HOPPER_TILE_CONFIGS
                assert tcm.vmem_working_set(s.cfg, dt) <= tcm.H100.vmem_bytes


def test_hopper_tiles_keep_alignment_and_fit_both_dtypes():
    f32, bf16 = tcm.profile_for("float32"), tcm.profile_for("bfloat16")
    fits = lambda dt: [c for c in tpol.HOPPER_TILE_CONFIGS  # noqa: E731
                       if tcm.vmem_working_set(c, dt) <= tcm.H100.vmem_bytes]
    assert fits(f32) and fits(bf16)
    assert tpol.TileConfig(64, 128, 128) in fits(f32)
    assert {8, 16} <= {c.bm for c in fits(bf16)}
    # every TPU tile overflows a Hopper block's shared memory at f32
    assert not [c for c in tpol.DEFAULT_TILE_CONFIGS
                if tcm.vmem_working_set(c, f32) <= tcm.H100.vmem_bytes]
