"""Federation and gossip of the port against ``repro``'s, on the CPU.

* ``merge_records``, ``merge_databases``, ``merge_journal_shards``,
  ``apply_journal_db``, ``merge_sieves`` and ``federate_selector`` give
  ``repro``'s records (sweep fields and commit stamps), ``MergeReport`` and
  sieve bytes on journal shards that each package wrote (a sharded sweep
  of the paper's suite, a same-stamp conflict and a newer supersession),
  in every shard order, and the result does not depend on that order.
* A journal that ``repro`` wrote on another arch class seeds the port's
  selector only as ``"xarch"``, never as a direct ``"tuned"`` hit.
* ``JournalTail`` reads what ``repro``'s does on torn (mid UTF-8 sequence),
  partial, malformed, blank and shrunk shards; ``GossipExchange`` absorbs a
  sibling's commits and hot-swaps them, after which each fingerprint is a
  ``tuned`` hit with no new miss.
* ``launch/tune.py --workers 3 --device cpu`` prints the records of
  ``examples/tune_gemm.py --workers 3`` and writes the same sieve header.
* The serve CLI's fleet flags on the CPU: ``--workers 2 --journal --adapt
  --gossip-every 2`` (worker 1 absorbs worker 0's commits), then
  ``--merge-journals`` (every dispatch a database hit).
"""

import dataclasses
import itertools
import json
import runpy
import sys
from pathlib import Path

import pytest

from repro.configs.gemm_suite import suite as j_suite
from repro.core import federate as j_fed
from repro.core import gossip as j_gossip
from repro.core import tuner as j_tuner
from repro.core.selector import KernelSelector as JKernelSelector
from repro.core.selector import SelectorState as JSelectorState
from repro_torch.configs.gemm_suite import suite
from repro_torch.core import federate as t_fed
from repro_torch.core import gossip as t_gossip
from repro_torch.core import tuner as t_tuner
from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveTuner
from repro_torch.core.selector import KernelSelector, SelectorState
from repro_torch.launch import serve as t_serve
from repro_torch.launch import tune as t_tune

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("size", "policy", "cfg", "g", "tflops", "runner_up_policy", "runner_up_tflops",
          "dp_best_tflops", "model_rank", "arch", "version", "wall")
FOREIGN = "tpu:l8:v16m:r275"


def rec_fields(rec):
    return tuple(getattr(rec, f) for f in FIELDS)


def db_fields(db):
    return ({k: rec_fields(r) for k, r in db.records.items()},
            {c: {k: rec_fields(r) for k, r in recs.items()} for c, recs in db.xarch.items()},
            db.per_policy, db.version, db.load_errors)


def _rec(mod, size, policy="dp", tflops=1.0, wall=0.0, version=0, arch="default"):
    return mod.TuningRecord(size=size, policy=policy, cfg="128x128x128", tflops=tflops,
                            runner_up_policy="all_sk", runner_up_tflops=tflops * 0.9,
                            dp_best_tflops=tflops, g=8, wall=wall, version=version, arch=arch)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Journal shards of a three-worker sweep of every 64th suite size,
    worker 1's written by the port and the others by ``repro``, and a
    fourth shard, written by the port, with a same-stamp conflict, a newer
    record that supersedes a sweep record, a torn tail and a foreign-class
    record."""
    tmp = tmp_path_factory.mktemp("shards")
    assert suite() == j_suite()
    sizes = suite()[::64]
    paths = []
    for i, mod in enumerate((j_tuner, t_tuner, j_tuner)):
        p = str(tmp / f"shard{i}.jsonl")
        mod.Tuner().tune(sizes, shard=(i, 3), journal=p)
        paths.append(p)
    with open(paths[0]) as f:
        first = j_tuner.parse_journal_line(f.readline())[0]
    extra = str(tmp / "extra.jsonl")
    for rec in (
        _rec(t_tuner, (64, 512, 256), "dp", 1.0, wall=5.0, version=3),
        _rec(t_tuner, first.size, "sk4dp", 9.0, wall=first.wall + 100.0, version=1),
        _rec(t_tuner, (32, 1024, 128), "sk1dp", 2.0, wall=7.0, version=4, arch=FOREIGN),
    ):
        t_tuner.append_journal(extra, rec)
    # the same stamp with another payload, in the shard repro wrote last
    j_tuner.append_journal(paths[2], _rec(j_tuner, (64, 512, 256), "sk2dp", 1.0, wall=5.0,
                                          version=3))
    with open(extra, "a") as f:
        f.write('{"key": "8,8,8", "rec')  # a torn final line
    return paths + [extra], sizes


def test_merge_journal_shards_matches_repro_in_every_order(shards):
    paths, sizes = shards
    results = set()
    for order in itertools.permutations(paths):
        jdb, jrep = j_fed.merge_journal_shards(list(order))
        tdb, trep = t_fed.merge_journal_shards(list(order))
        assert db_fields(tdb) == db_fields(jdb)
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
        assert tdb.build_sieve().to_bytes() == jdb.build_sieve().to_bytes()
        results.add(json.dumps([sorted(map(str, db_fields(tdb)[0].items()))]))
    assert len(results) == 1  # the merge does not depend on the shard order
    assert trep.conflicts == 1 and trep.superseded >= 2 and trep.sources == 4
    assert len(tdb.records) == len(sizes) + 1 and set(tdb.xarch) == {FOREIGN}
    assert tdb.records[(64, 512, 256)].policy == "sk2dp"  # the name order breaks the tie


def _load(mod, path, arch="default"):
    db = mod.TuningDatabase(arch=arch)
    db.replay_journal(path)
    return db


def test_merge_databases_records_and_apply_journal_match_repro(shards):
    paths, _ = shards
    for order in (paths, paths[::-1]):
        jdb, jrep = j_fed.merge_databases([_load(j_tuner, p) for p in order])
        tdb, trep = t_fed.merge_databases([_load(t_tuner, p) for p in order])
        assert db_fields(tdb) == db_fields(jdb)
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    # merge_records on its own, into a non-empty database, with a report
    jinto, tinto = _load(j_tuner, paths[0]), _load(t_tuner, paths[0])
    jsrc, tsrc = _load(j_tuner, paths[3]), _load(t_tuner, paths[3])
    jrep = j_fed.merge_records(jinto, [(r, None) for r in jsrc.records.values()])
    trep = t_fed.merge_records(tinto, [(r, None) for r in tsrc.records.values()])
    assert db_fields(tinto) == db_fields(jinto)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    # a journal applied on top of a snapshot wins whatever the stamps say
    jsnap, tsnap = _load(j_tuner, paths[1]), _load(t_tuner, paths[1])
    jj, _ = j_fed.merge_journal_shards(paths[2:])
    tj, _ = t_fed.merge_journal_shards(paths[2:])
    assert db_fields(t_fed.apply_journal_db(tsnap, tj)) == db_fields(
        j_fed.apply_journal_db(jsnap, jj))
    assert t_fed.record_payload(tsnap.records[next(iter(tj.records))]).version == 0


def test_merge_sieves_matches_repro(shards):
    paths, _ = shards
    jsieves = [_load(j_tuner, p).build_sieve(generation=g) for g, p in enumerate(paths)]
    tsieves = [_load(t_tuner, p).build_sieve(generation=g) for g, p in enumerate(paths)]
    for gen in (None, 11):
        jm, tm = j_fed.merge_sieves(jsieves, generation=gen), t_fed.merge_sieves(tsieves,
                                                                                 generation=gen)
        assert tm.to_bytes() == jm.to_bytes() and tm.generation == jm.generation
    assert tsieves[0].generation == 0  # the inputs are not mutated
    with pytest.raises(ValueError, match="at least one"):
        t_fed.merge_sieves([])


def test_federate_selector_matches_repro(shards):
    paths, sizes = shards
    jsel = JKernelSelector(state=JSelectorState(db=_load(j_tuner, paths[0])))
    tsel = KernelSelector(state=SelectorState(db=_load(t_tuner, paths[0])))
    jst = j_fed.federate_selector(jsel, journals=paths[1:],
                                  sieves=[_load(j_tuner, paths[1]).build_sieve()])
    tst = t_fed.federate_selector(tsel, journals=paths[1:],
                                  sieves=[_load(t_tuner, paths[1]).build_sieve()])
    assert dataclasses.asdict(tst.report) == dataclasses.asdict(jst.report)
    assert (tst.merged, tst.conflicts) == (jst.merged, jst.conflicts)
    assert db_fields(tsel.db) == db_fields(jsel.db)
    assert tsel.sieve.to_bytes() == jsel.sieve.to_bytes()
    assert tsel.sieve_generation == jsel.sieve_generation
    for size in sizes:
        assert tsel.select(*size).source == jsel.select(*size).source == "tuned"
    keys = list(tsel.db.records)
    assert t_fed.selection_table(tsel, keys) == j_fed.selection_table(jsel, keys)
    with pytest.raises(ValueError, match="mismatched parameters"):
        t_fed.federate_selector(tsel, capacity=10, fp_rate=0.5)


def test_repro_journal_of_another_class_seeds_only_xarch(tmp_path):
    shard = str(tmp_path / "foreign.jsonl")
    foreign = _rec(j_tuner, (48, 2048, 512), "sk2dp", 3.0, wall=1.0, arch=FOREIGN)
    j_tuner.append_journal(shard, foreign)
    tsel = KernelSelector()
    st = t_fed.federate_selector(tsel, journals=[shard])
    assert not tsel.db.records and set(tsel.db.xarch) == {FOREIGN} and st.merged == 1
    assert tsel.select(*foreign.size).source == "xarch"
    assert tsel.stats.xarch_seeds == 1 and tsel.stats.tuned_hits == 0


# -- gossip ----------------------------------------------------------------------


def test_journal_tail_reads_what_repro_reads(tmp_path):
    shard = tmp_path / "s.jsonl"
    line = lambda size: t_tuner.journal_entry(_rec(t_tuner, size)) + "\n"  # noqa: E731
    entry = json.loads(t_tuner.journal_entry(_rec(t_tuner, (128, 256, 512))))
    entry["note"] = "émigré"
    torn = json.dumps(entry, ensure_ascii=False).encode("utf-8")
    cut = torn.index("é".encode("utf-8")) + 1  # inside a multi-byte sequence
    a, b, c = line((64, 512, 256)).encode(), line((32, 1024, 128)).encode(), line((8, 8, 8))
    states = [a + torn[:cut]]  # a torn tail
    states.append(a + torn + b"\n{not json\n\n")  # healed, then malformed and blank lines
    states.append(states[-1] + b + line((16, 16, 16)).encode()[:9])  # grown, a partial line
    states.append(c.encode())  # shrunk: re-read from byte 0
    jtail, ttail = j_gossip.JournalTail(str(shard)), t_gossip.JournalTail(str(shard))
    assert jtail.poll() == ttail.poll() == []  # no shard yet
    for data in states:
        shard.write_bytes(data)
        assert ttail.poll() == jtail.poll()
        assert (ttail.offset, ttail.load_errors) == (jtail.offset, jtail.load_errors)
    assert ttail.load_errors == 1
    with pytest.raises(FileNotFoundError):
        t_gossip.JournalTail(str(tmp_path / "never.jsonl"), missing_ok=False).poll()


def test_gossip_exchange_absorbs_sibling_commits_and_hot_swaps(tmp_path):
    shard_a = str(tmp_path / "a.jsonl")
    sizes = [(64, 512, 256), (128, 256, 512), (32, 1024, 128)]
    sel_a = KernelSelector()
    ad_a = AdaptiveTuner(sel_a, config=AdaptiveConfig(hot_threshold=1), journal=shard_a)
    sel_b = KernelSelector()
    ad_b = AdaptiveTuner(sel_b, config=AdaptiveConfig(hot_threshold=1))
    gossip_b = t_gossip.GossipExchange(sel_b, [shard_a, str(tmp_path / "absent.jsonl")])
    jsel = JKernelSelector()
    jgossip = j_gossip.GossipExchange(jsel, [shard_a, str(tmp_path / "absent.jsonl")])
    assert gossip_b.exchange() == jgossip.exchange() == 0  # quiet round
    assert gossip_b.stats.swaps == 0
    for s in sizes:
        sel_a.select(*s)
    assert ad_a.drain() == len(sizes)
    assert gossip_b.exchange() == jgossip.exchange() == len(sizes)
    misses = ad_b.stats.misses
    for s in sizes:
        assert sel_b.select(*s).source == jsel.select(*s).source == "tuned"
    assert ad_b.stats.misses == misses  # direct database hits: no miss
    assert dataclasses.asdict(gossip_b.stats) == dataclasses.asdict(jgossip.stats)
    assert gossip_b.stats.entries == len(sizes) and gossip_b.stats.swaps == 1
    assert sel_b.sieve_generation == jsel.sieve_generation == 1
    assert db_fields(sel_b.db) == db_fields(jsel.db)


# -- entry points ----------------------------------------------------------------


def test_tune_cli_workers_prints_the_example_records(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tune_gemm.py", "--stride", "64", "--workers", "3",
                                      "--out", str(tmp_path / "j.hpp")])
    runpy.run_path(str(ROOT / "examples" / "tune_gemm.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    assert t_tune.main(["--device", "cpu", "--stride", "64", "--workers", "3", "--out",
                        str(tmp_path / "t.hpp")]) == 0
    got = capsys.readouterr().out.splitlines()
    pick = lambda lines, head: [x for x in lines if x.startswith(head)]  # noqa: E731
    for head in ("federated:", "winners:", "data-parallel optimal:", "stream-k-based optimal:",
                 "true-negative rate:"):
        assert pick(got, head) == pick(want, head) and pick(got, head), head
    assert "0 conflicts" in pick(got, "federated:")[0]
    assert (tmp_path / "t.hpp").read_bytes() == (tmp_path / "j.hpp").read_bytes()


def test_serve_cli_fleet_gossips_then_warm_starts_merged(tmp_path):
    journal = str(tmp_path / "fleet.jsonl")
    base = ["--arch", "granite-8b", "--device", "cpu", "--paged", "--prefill-chunk", "16",
            "--replay", "poisson", "--requests", "4", "--slots", "2", "--max-seq", "64",
            "--max-new-tokens", "3", "--workers", "2", "--journal", journal, "--top-k", "3",
            "--gossip-every", "2"]
    first = tmp_path / "first.json"
    assert t_serve.main(base + ["--adapt", "--adapt-every", "1", "--summary-json",
                                str(first)]) == 0
    run = json.loads(first.read_text())
    assert run["completed"] == 4
    w0, w1 = run["workers"]
    assert w1["gossip"]["rounds"] > 0 and w1["gossip"]["entries"] > 0
    assert w0["adaptations"] > 0
    assert run["federation"]["records"] > 0 and run["federation"]["sources"] == 2
    assert Path(journal + ".shard0").exists() and Path(journal + ".shard1").exists()
    second = tmp_path / "second.json"
    assert t_serve.main(base + ["--merge-journals", "--summary-json", str(second)]) == 0
    run = json.loads(second.read_text())
    assert run["completed"] == 4
    for w in run["workers"]:
        assert set(w["sources"]) == {"tuned"} and w["decode_sources"]["tuned"] > 0
