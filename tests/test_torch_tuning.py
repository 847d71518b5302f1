"""The tuning, calibration and online-adaptation path of the port against
``repro``'s, on the CPU.

Both sides measure with the analytical model (``measure_model``; ``repro``
on the CPU as its own tests run it), so equal inputs must give equal
records, float for float: the sweep, the top-k budget, the snapshot and
journal codecs (byte-compatible both ways), the sieve's bytes, the
calibration fit (1e-9 relative), the selector's ``"model"`` picks, the
adaptive tuner's commits and, end to end, the fingerprints a reduced
granite-8b engine commits at ``hot_threshold=1``. ``measure_wallclock``
needs the card: on a CPU device it raises (its card test is in
``tests/test_torch_cuda.py``).
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs.gemm_suite import suite as j_suite
from repro.core import arch as j_arch
from repro.core import calibrate as j_cal
from repro.core import costmodel as j_cm
from repro.core import tuner as j_tuner
from repro.core.adaptive import AdaptiveConfig as JAdaptiveConfig
from repro.core.adaptive import AdaptiveTuner as JAdaptiveTuner
from repro.core.gemm import gemm_context as j_gemm_context
from repro.core.op import Epilogue as JEpilogue
from repro.core.op import GemmOp as JGemmOp
from repro.core.selector import KernelSelector as JKernelSelector
from repro.core.selector import SelectorState as JSelectorState
from repro.dist.sharding import materialize_tree
from repro.models.lm import LM as JLM
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.configs.gemm_suite import suite
from repro_torch.core import arch as t_arch
from repro_torch.core import calibrate as t_cal
from repro_torch.core import costmodel as t_cm
from repro_torch.core import tuner as t_tuner
from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveTuner
from repro_torch.core.op import Epilogue, GemmOp
from repro_torch.core.selector import KernelSelector, SelectorState
from repro_torch.launch import tune as t_tune
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

ROOT = Path(__file__).resolve().parent.parent

#: the fields a sweep decides (the commit stamps version/wall are the
#: producer's clock, not the measurement)
SWEPT = ("size", "policy", "cfg", "g", "tflops", "runner_up_policy", "runner_up_tflops",
         "dp_best_tflops", "model_rank", "arch")


def swept(rec):
    return tuple(getattr(rec, f) for f in SWEPT)


def both_ops():
    """The same GemmOp targets on both sides: bf16, f32 x int8 and int8 x
    int4 with an epilogue, and one fused grouped op."""
    specs = [
        dict(m=4, n=4096, k=4096, in_dtype="bfloat16", out_dtype="bfloat16"),
        dict(m=57, n=14336, k=4096, in_dtype="float32*int8", out_dtype="float32",
             epilogue=dict(activation="gelu", bias=True)),
        dict(m=4, n=1024, k=4096, in_dtype="int8*int4", out_dtype="bfloat16",
             epilogue=dict(binary="mul_silu")),
        dict(m=16, n=1024, k=2048, g=64, kind="grouped", fused=True, in_dtype="bfloat16",
             out_dtype="bfloat16"),
    ]
    out = []
    for cls, epi in ((JGemmOp, JEpilogue), (GemmOp, Epilogue)):
        ops = []
        for spec in specs:
            spec = dict(spec)
            spec["epilogue"] = epi(**spec.get("epilogue", {}))
            ops.append(cls(**spec))
        out.append(ops)
    return out


@pytest.fixture(scope="module")
def suite_dbs():
    assert suite() == j_suite()
    sizes = suite()[::32]
    return j_tuner.Tuner().tune(sizes), t_tuner.Tuner().tune(sizes)


def assert_same_db(jdb, tdb):
    assert list(jdb.records) == list(tdb.records)
    for key in jdb.records:
        assert swept(jdb.records[key]) == swept(tdb.records[key]), key
    assert jdb.per_policy == tdb.per_policy


# -- the sweep ------------------------------------------------------------------


def test_tuner_records_match_repro_on_the_suite(suite_dbs):
    jdb, tdb = suite_dbs
    assert len(tdb.records) == len(suite()[::32])
    assert_same_db(jdb, tdb)


def test_tuner_records_match_repro_on_gemm_op_targets():
    jops, tops = both_ops()
    assert [o.key for o in jops] == [o.key for o in tops]
    jt, tt = j_tuner.Tuner(), t_tuner.Tuner()
    assert_same_db(jt.tune(jops), tt.tune(tops))
    assert jt.measurements == tt.measurements


def test_shards_match_repro_and_cover_the_sweep(suite_dbs):
    jdb, tdb = suite_dbs
    sizes = suite()[::32]
    for n in (1, 2, 5):
        for i in range(n):
            assert t_tuner.shard_targets(sizes, i, n) == j_tuner.shard_targets(sizes, i, n)
    for bad in ((0, 0), (2, 2), (-1, 2)):
        for mod in (j_tuner, t_tuner):
            with pytest.raises(ValueError):
                mod.shard_targets(sizes, *bad)
    assert_same_db(j_tuner.Tuner().tune(sizes, shard=(1, 3)),
                   t_tuner.Tuner().tune(sizes, shard=(1, 3)))
    # the shards are disjoint and together hold the unsharded sweep's records
    seen = {}
    for i in range(3):
        shard = t_tuner.Tuner().tune(sizes, shard=(i, 3))
        assert not set(shard.records) & set(seen)
        seen.update(shard.records)
        for key, rec in shard.records.items():
            assert swept(rec) == swept(tdb.records[key]) == swept(jdb.records[key])
            assert shard.per_policy[key] == tdb.per_policy[key]
    assert set(seen) == set(tdb.records)


@pytest.mark.parametrize("targets", ["suite", "ops"])
def test_top_k_tuner_matches_repro(targets):
    jops, tops = both_ops()
    jsizes, tsizes = (j_suite()[::32], suite()[::32]) if targets == "suite" else (jops, tops)
    jt, tt = j_tuner.Tuner(top_k=3), t_tuner.Tuner(top_k=3)
    jdb, tdb = jt.tune(jsizes), tt.tune(tsizes)
    assert_same_db(jdb, tdb)
    assert jt.measurements == tt.measurements


def test_top_k_budget_is_smaller_than_the_full_sweep():
    _, tops = both_ops()
    full, top = t_tuner.Tuner(), t_tuner.Tuner(top_k=3)
    full.tune(tops)
    top.tune(tops)
    assert top.measurements < full.measurements


# -- snapshots and journal ------------------------------------------------------


def planted_db(tuner_mod, cm_mod):
    planted = dataclasses.replace(cm_mod.V5E, hbm_bw=600e9, launch_overhead_s=5e-6,
                                  fixup_serial_s=3e-6)
    squareish = [(m, n, k) for m in (64, 128, 256, 512) for n in (128, 256, 512)
                 for k in (128, 512)][:20]
    skinny = [(8, 128, 4096), (16, 128, 8192), (8, 256, 4096), (16, 64, 8192),
              (32, 128, 4096), (8, 128, 8192), (16, 256, 4096), (32, 64, 8192)]
    return tuner_mod.Tuner(mach=planted).tune(squareish + skinny)


@pytest.fixture(scope="module")
def planted():
    jdb, tdb = planted_db(j_tuner, j_cm), planted_db(t_tuner, t_cm)
    return jdb, tdb, j_cal.calibrate_db(jdb), t_cal.calibrate_db(tdb)


def dressed(db, cal_mod, arch_mod, cm):
    """A database with every snapshot section: a calibration, a foreign
    class's record and an arch profile."""
    db.set_calibration(cm, stamp=False)
    rec = next(iter(db.records.values()))
    db.add_record(dataclasses.replace(rec, arch="gpu:l132:v0m:r300", version=3, wall=5.0),
                  stamp=False)
    db.note_arch_profile(arch_mod.ArchProfile(backend="gpu", lanes=132, vmem_bytes=232448,
                                              flops_per_byte=300))
    return db


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_snapshot_round_trip_both_ways(tmp_path, planted, writer):
    jdb, tdb, jcm, tcm = planted
    jdb = dressed(j_tuner.TuningDatabase(records=dict(jdb.records),
                                         per_policy=dict(jdb.per_policy)), j_cal, j_arch, jcm)
    tdb = dressed(t_tuner.TuningDatabase(records=dict(tdb.records),
                                         per_policy=dict(tdb.per_policy)), t_cal, t_arch, tcm)
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jdb.save(str(jpath))
    tdb.save(str(tpath))
    # the same database gives the same payload on both sides (the hybrid
    # stamps of the freshly committed records aside)
    jj, tj = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    for d in (jj, tj):
        for rec in d["records"].values():
            rec.pop("wall")
            rec.pop("version")
    assert jj == tj
    src = tpath if writer == "port" else jpath
    jback = j_tuner.TuningDatabase.load(str(src))
    tback = t_tuner.TuningDatabase.load(str(src))
    assert jback.load_errors == tback.load_errors == 0
    assert {k: dataclasses.asdict(r) for k, r in jback.records.items()} == {
        k: dataclasses.asdict(r) for k, r in tback.records.items()}
    assert {c: {k: dataclasses.asdict(r) for k, r in recs.items()}
            for c, recs in jback.xarch.items()} == {
        c: {k: dataclasses.asdict(r) for k, r in recs.items()} for c, recs in tback.xarch.items()}
    assert j_cal.calibration_to_json(jback.calibration) == t_cal.calibration_to_json(
        tback.calibration)
    assert {c: p.to_json() for c, p in jback.arch_profiles.items()} == {
        c: p.to_json() for c, p in tback.arch_profiles.items()}
    assert jback.per_policy == tback.per_policy and jback.version == tback.version


def test_journal_lines_parse_both_ways(planted):
    jdb, tdb, jcm, tcm = planted
    for key in jdb.records:
        jline = j_tuner.journal_entry(jdb.records[key], jdb.per_policy[key])
        tline = t_tuner.journal_entry(tdb.records[key], tdb.per_policy[key])
        jrec, jpp = j_tuner.parse_journal_line(tline)
        trec, tpp = t_tuner.parse_journal_line(jline)
        assert dataclasses.asdict(jrec) == dataclasses.asdict(tdb.records[key])
        assert dataclasses.asdict(trec) == dataclasses.asdict(jdb.records[key])
        assert jpp == tpp == jdb.per_policy[key]
    # the calibration line and the arch line: the same bytes, parsed back
    assert j_cal.calibration_entry(jcm) == t_cal.calibration_entry(tcm)
    back = t_cal.calibration_from_json(json.loads(j_cal.calibration_entry(jcm))["calibration"])
    assert back == tcm
    prof = dict(backend="cuda", lanes=132, vmem_bytes=232448, flops_per_byte=300)
    jline = j_arch.arch_entry(j_arch.ArchProfile(**prof))
    assert jline == t_arch.arch_entry(t_arch.ArchProfile(**prof))
    assert t_arch.ArchProfile.from_json(json.loads(jline)["arch"]) == t_arch.ArchProfile(**prof)


def test_replay_journal_rebuilds_the_same_database(tmp_path, planted):
    jdb, tdb, jcm, tcm = planted
    path = tmp_path / "journal.jsonl"
    for key, rec in tdb.records.items():
        t_tuner.append_journal(str(path), rec, tdb.per_policy[key])
    t_cal.append_calibration(str(path), tcm)
    t_arch.append_arch(str(path), t_arch.ArchProfile(backend="cuda", lanes=132))
    with open(path, "a") as f:
        f.write('{"future_tag": 1}\n{"key": "torn')  # an unknown tag, a torn last line
    jback, tback = j_tuner.TuningDatabase(), t_tuner.TuningDatabase()
    assert jback.replay_journal(str(path)) == tback.replay_journal(str(path)) == len(
        tdb.records) + 2
    assert jback.load_errors == tback.load_errors == 2
    assert {k: dataclasses.asdict(r) for k, r in jback.records.items()} == {
        k: dataclasses.asdict(r) for k, r in tback.records.items()}
    assert jback.version == tback.version
    assert t_cal.calibration_to_json(tback.calibration) == j_cal.calibration_to_json(
        jback.calibration)
    assert list(tback.arch_profiles) == list(jback.arch_profiles)


# -- the sieve ------------------------------------------------------------------


def test_sieve_bytes_equal_and_true_negatives(suite_dbs):
    jdb, tdb = suite_dbs
    jops, tops = both_ops()
    jdb2, tdb2 = j_tuner.Tuner().tune(jops), t_tuner.Tuner().tune(tops)
    for j, t in ((jdb, tdb), (jdb2, tdb2)):
        js, ts = j.build_sieve(generation=3), t.build_sieve(generation=3)
        assert js.to_bytes() == ts.to_bytes()
        assert ts.generation == js.generation == 3
        assert ts.validate_true_negative_rate(t.winners()) == 1.0
        assert js.validate_true_negative_rate(j.winners()) == 1.0
        assert ts.summary() == js.summary()


# -- calibration ----------------------------------------------------------------


def test_calibration_fits_the_same_machine(planted):
    jdb, tdb, jcm, tcm = planted
    assert tcm.fitted_profiles == jcm.fitted_profiles and tcm.n_records == jcm.n_records
    for (jk, jm), (tk, tm) in zip(jcm.profiles, tcm.profiles):
        assert jk == tk
        for f in ("peak_flops", "hbm_bw", "launch_overhead_s", "fixup_serial_s"):
            want, got = getattr(jm, f), getattr(tm, f)
            assert got == pytest.approx(want, rel=1e-9, abs=0), (tk, f)
    assert tcm.residual == pytest.approx(jcm.residual, rel=1e-9, abs=1e-12)
    # the fit recovers the planted terms, as repro's own test demands
    m = tcm.machine_for(t_cm.profile_for("float32", "float32"))
    assert m.hbm_bw == pytest.approx(600e9, rel=1e-3)


def test_calibration_refused_at_the_same_floor(planted):
    jdb, tdb, _, _ = planted
    assert t_cal.MIN_RECORDS == j_cal.MIN_RECORDS == 16
    items = list(tdb.records.items())
    jitems = list(jdb.records.items())
    for n in (t_cal.MIN_RECORDS - 1, t_cal.MIN_RECORDS):
        refused = []
        for cal, recs in ((j_cal, jitems[:n]), (t_cal, items[:n])):
            try:
                cal.calibrate_records(recs)
            except cal.CalibrationError:
                refused.append(True)
            else:
                refused.append(False)
        assert refused == [n < t_cal.MIN_RECORDS] * 2, n


# -- the selector ---------------------------------------------------------------


def test_model_source_picks_match_repro(planted):
    jdb, tdb, jcm, tcm = planted
    jops, tops = both_ops()
    shapes = [(4, 4096, 4096), (57, 1024, 4096), (300, 200, 520), (8, 49152, 4096)]
    jops += [JGemmOp.plain(*s) for s in shapes]
    tops += [GemmOp.plain(*s) for s in shapes]
    # an empty database's sieve answers "absent" for everything: the
    # calibrated model picks
    jsel = JKernelSelector(state=JSelectorState(db=j_tuner.TuningDatabase(), calibration=jcm,
                                                sieve=j_tuner.TuningDatabase().build_sieve()))
    tsel = KernelSelector(state=SelectorState(db=t_tuner.TuningDatabase(), calibration=tcm,
                                              sieve=t_tuner.TuningDatabase().build_sieve()))
    for jo, to in zip(jops, tops):
        js, ts = jsel.select_op(jo), tsel.select_op(to)
        assert ts.source == js.source == "model"
        assert (ts.policy.name, ts.cfg.name, ts.g, ts.evals, ts.pruned) == (
            js.policy.name, js.cfg.name, js.g, js.evals, js.pruned)
    assert tsel.stats.model_warm == jsel.stats.model_warm == len(tops)
    assert tsel.scoring_machine(t_cm.profile_for("float32")) == tcm.machine_for(
        t_cm.profile_for("float32"))


def test_hot_swap_drops_exactly_the_named_keys():
    ops = [GemmOp.plain(m, 256, 512) for m in (4, 8, 16)]
    sel = KernelSelector()
    for op in ops:
        sel.select_op(op)
    assert sel.hot_swap(keys=[ops[0].key, (999, 1, 1)]) == 1
    assert sel.select_op(ops[1]) and sel.stats.cache_hits == 1
    sel.select_op(ops[0])
    assert sel.stats.cache_hits == 1  # re-resolved, not a memo hit
    # a new calibration drops every memoised pick, whatever keys say
    cm = t_cal.CalibratedMachine()
    assert sel.hot_swap(state=SelectorState(calibration=cm), keys=[]) == 3
    assert sel.calibration is cm and sel.select_op(ops[2]).source == "model"
    # the same state: only the named keys go
    assert sel.hot_swap(state=sel.state, keys=[ops[2].key]) == 1
    assert sel.hot_swap() == 0


def test_miss_hook_sees_every_non_tuned_dispatch():
    seen = []
    db = t_tuner.TuningDatabase()
    op_tuned, op_cold = GemmOp.plain(4, 256, 512), GemmOp.plain(8, 256, 512)
    rec, pp = t_tuner.Tuner().tune_size(op_tuned)
    db.add_record(rec, pp)
    sel = KernelSelector(state=SelectorState(db=db), on_miss=lambda op, s: seen.append(
        (op.key, s.source)))
    for _ in range(2):
        sel.select_op(op_tuned)
        sel.select_op(op_cold)
    sel.select_partial(op_cold, g=4)
    sel.record_forced(op_cold, t_tuner.DP, t_tuner.DEFAULT_TILE_CONFIGS[0])
    sel.record_forced(op_tuned, t_tuner.DP, t_tuner.DEFAULT_TILE_CONFIGS[0])
    # per dispatch, memo hits included; tuned hits and forced tuned ones never
    assert [k for k, _ in seen] == [op_cold.key] * 4
    assert [s for _, s in seen] == ["fallback", "fallback", "fallback", "forced"]


# -- adaptation -----------------------------------------------------------------


def miss_stream(opcls, epicls):
    shapes = [(4, 512, 256), (8, 512, 256), (4, 256, 512), (16, 1024, 256), (4, 512, 256),
              (32, 128, 2048), (8, 512, 256), (4, 256, 512), (64, 512, 512), (2, 128, 128)]
    ops = [opcls.plain(*s, in_dtype="bfloat16") for s in shapes]
    ops.append(opcls.plain(4, 512, 256, epilogue=epicls(activation="silu")))
    return ops


@pytest.mark.parametrize("hot_threshold", [1, 2])
def test_adaptive_tuner_commits_like_repro(tmp_path, hot_threshold):
    cfg = dict(hot_threshold=hot_threshold, max_tunes_per_step=2, rebuild_every=2, top_k=3)
    out = {}
    for side, (sel_cls, st_cls, tuner_mod, at_cls, ac_cls, ops) in {
        "repro": (JKernelSelector, JSelectorState, j_tuner, JAdaptiveTuner, JAdaptiveConfig,
                  miss_stream(JGemmOp, JEpilogue)),
        "port": (KernelSelector, SelectorState, t_tuner, AdaptiveTuner,
                 AdaptiveConfig, miss_stream(GemmOp, Epilogue)),
    }.items():
        db = tuner_mod.TuningDatabase()
        sel = sel_cls(state=st_cls(db=db, sieve=db.build_sieve()))
        journal = tmp_path / f"{side}.jsonl"
        ad = at_cls(sel, config=ac_cls(**cfg), journal=str(journal))
        commits, gens = [], []
        for i, op in enumerate(ops):
            sel.select_op(op)
            if i % 3 == 2:
                before = set(db.records)
                ad.adapt()
                commits += [k for k in db.records if k not in before]
                gens.append((sel.sieve_generation, sel.sieve.to_bytes()))
        before = set(db.records)
        ad.drain()
        commits += [k for k in db.records if k not in before]
        gens.append((sel.sieve_generation, sel.sieve.to_bytes()))
        lines = [json.loads(line) for line in journal.read_text().splitlines()]
        for e in lines:
            e["record"].pop("wall")
        out[side] = (commits, gens, lines, dataclasses.asdict(ad.stats))
    assert out["port"] == out["repro"]
    assert out["port"][0]  # something was committed


@pytest.fixture(scope="module")
def engine_pair():
    jcfg = dataclasses.replace(j_get_reduced("granite-8b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("granite-8b"), dtype="float32")
    jmodel = JLM(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, LM(cfg), params


def test_served_engine_commits_the_same_fingerprints(engine_pair):
    jmodel, jparams, model, params = engine_pair
    prompts = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64])]
    cfg = dict(hot_threshold=1, max_tunes_per_step=8, rebuild_every=4)

    jdb = j_tuner.TuningDatabase()
    jad = JAdaptiveTuner(JKernelSelector(state=JSelectorState(db=jdb, sieve=jdb.build_sieve())),
                         config=JAdaptiveConfig(**cfg))
    jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=32, eos=-1),
                        adaptive=jad, adapt_every=1)
    with j_gemm_context(backend="xla"):
        for p in prompts:
            jeng.submit(p, max_new_tokens=3)
        jeng.run()

    db = t_tuner.TuningDatabase()
    ad = AdaptiveTuner(KernelSelector(state=SelectorState(db=db, sieve=db.build_sieve())),
                       config=AdaptiveConfig(**cfg))
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=32, eos=-1),
                      adaptive=ad, adapt_every=1, backend="torch", device="cpu")
    assert eng.selector is ad.selector
    for p in prompts:
        eng.submit(p, max_new_tokens=3)
    done = eng.run()
    assert len(done) == 2
    assert set(db.records) == set(jdb.records) and db.records
    for key in db.records:
        assert swept(db.records[key]) == swept(jdb.records[key])
    st = eng.dispatch_stats
    assert st.adaptations == len(db.records) and st.pending_hot == 0
    assert st.misses >= len(db.records) and st.sieve_generation >= 1
    # a second wave over the same shapes dispatches from the database only
    start = len(eng.selection_log)
    for p in prompts:
        eng.submit(p, max_new_tokens=3)
    eng.run()
    assert {e.selection.source for e in eng.selection_log[start:]} == {"tuned"}


# -- entry point and guards -----------------------------------------------------


def test_tune_cli_prints_the_same_winners_as_the_example(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tune_gemm.py", "--stride", "64", "--out",
                                      str(tmp_path / "j.hpp")])
    runpy.run_path(str(ROOT / "examples" / "tune_gemm.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    assert t_tune.main(["--device", "cpu", "--stride", "64", "--out",
                        str(tmp_path / "t.hpp")]) == 0
    got = capsys.readouterr().out.splitlines()
    pick = lambda lines, head: [x for x in lines if x.startswith(head)]  # noqa: E731
    for head in ("winners:", "data-parallel optimal:", "stream-k-based optimal:",
                 "true-negative rate:"):
        assert pick(got, head) == pick(want, head) and pick(got, head), head
    assert (tmp_path / "t.hpp").read_bytes() == (tmp_path / "j.hpp").read_bytes()
    assert pick(got, "sieve elimination rate over the tuned sizes:")


def test_tune_cli_refuses_workers(tmp_path):
    # a federated sweep takes one worker or more (tests/test_torch_federate.py)
    with pytest.raises(SystemExit, match="--workers must be >= 1"):
        t_tune.main(["--device", "cpu", "--workers", "0", "--out", str(tmp_path / "x.hpp")])


def test_measure_wallclock_has_no_cpu_fallback():
    with pytest.raises(ValueError, match="no CPU fallback"):
        t_tuner.measure_wallclock(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_tuner.measure_wallclock()


def test_serve_cli_warm_starts_from_its_journal(tmp_path):
    """``launch/serve.py --journal --adapt`` on the CPU journals every
    fingerprint it missed; a second run replays that journal (and with
    ``--calibrate`` fits and journals a calibration), serves every dispatch
    from the database and so commits nothing more."""
    from repro_torch.launch import serve as t_serve

    journal = tmp_path / "serve.jsonl"
    argv = ["--arch", "granite-8b", "--device", "cpu", "--requests", "2", "--max-new-tokens",
            "3", "--max-seq", "64", "--journal", str(journal), "--adapt", "--adapt-every", "1",
            "--top-k", "3"]
    assert t_serve.main(argv) == 0
    first = journal.read_text().splitlines()
    assert first and all('"record"' in line for line in first)
    assert t_serve.main(argv + ["--calibrate"]) == 0
    lines = journal.read_text().splitlines()
    assert lines[: len(first)] == first
    assert [json.loads(x).keys() for x in lines[len(first):]] == [{"calibration"}]
    db = t_tuner.TuningDatabase()
    db.replay_journal(str(journal))
    assert len(db.records) == len(first) and db.calibration is not None
