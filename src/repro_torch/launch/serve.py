"""Serve an LM through the port: ``python -m repro_torch.launch.serve``.

Builds the model with random weights from a seeded ``torch.Generator``,
submits ``--requests`` seeded prompts to a :class:`ServeEngine`, drains it,
and logs throughput plus the Stream-K++ dispatch decisions the traffic made.
Every decoder-only arch serves (dense, MoE, SSM, hybrid, and the VLM on its
text); the encoder-decoder is refused, as ``repro``'s CLI refuses it
(``EncDec.prefill`` and ``EncDec.decode_step`` serve it).
It runs on the CUDA device through the hand-written kernels unless
``--device cpu`` is given (then the ``torch`` backend serves, unless
``--backend cuda`` asks for the kernels' plain versions). ``--quantize``
serves on a rung of the quantization ladder: the projection weights are
quantized on the serving device, one leaf (and one layer of a stacked leaf)
at a time.

Tuning artifacts: ``--db`` loads a snapshot and ``--journal`` replays a
journal on top of it (and takes ``--adapt``'s commits and ``--calibrate``'s
fit), ``--calibrate`` fits the cost model to the warm records' wall
clocks, and the selector then
dispatches from the database, the sieve built from it and the calibration.
``--adapt`` tunes untuned fingerprints between decode steps
(``--adapt-every``, ``--adapt-threshold``, ``--adapt-budget``,
``--top-k``): on the card each candidate is timed on the hand-written
kernels, on the CPU the analytical model stands in. ``--arch-class auto``
stamps records with the live device's class, ``--grid-sweep`` and
``--mach-json`` set the grid sizes and the machine the selector scores
under (default: the nominal H100 and 66, 132, 264 on the card; TPU-v5e on
the CPU).

Paged serving: ``--paged`` serves through :class:`PagedServeEngine` (a page
pool of ``--max-pages`` pages of ``--page-size`` KV rows; 0 sizes it to the
dense engine's rows, ``slots * max_seq / page_size``, for an equal-memory
comparison; oldest-first admission under a watermark reserve), and
``--prefill-chunk N`` prefills prompts N tokens at a time, one chunk per
engine step. ``--replay poisson|bursty`` offers the requests on a synthetic
arrival process (``--replay-rate`` arrivals per engine step) instead of all
up front, and logs the per-request SLO summary in engine steps.

The fleet: ``--workers K`` serves the requests (dealt round-robin) through K
engines with separate selector, tuner and database state, one after
another on the one device, each journaling to its own shard
``<journal>.shard<i>``; ``--merge-journals`` warm-starts every worker from
the federation of every shard (``core/federate.py``), and ``--gossip-every
N`` folds the siblings' fresh commits into each worker's live selector
every N engine steps (``core/gossip.py``).

``--mesh-model N`` installs a sharding plan over the host's ranks as
(data, model = N) (``launch/mesh.py make_host_mesh``). One process (N = 1)
runs every GEMM whole, with the plan's divisors in its fingerprints
(``serve_gemm_div``). Across W ranks, one process each, started by
``torch.distributed.run``, the mesh is (data = W / N, model = N): the CLI
joins the ``gloo`` group the launcher describes (ranks that share one card
cannot use NCCL), every rank holds its shard of the weights (drawn from the
same seed as one rank's; ``--quantize`` then quantizes the shards as
``repro`` quantizes the whole leaves) and of the caches, takes the same
request stream and runs the tensor-, expert- and FSDP-parallel step on the
hand-written kernels at its local shapes, exchanging what the layout needs
(``dist/collectives.py``). Where data > 1 divides ``--slots`` each data
rank decodes its own slots, and the logits are gathered. Rank 0 writes
``--summary-json``, with the rung, the mesh, the collectives of a decode
step and their share of the decode time. ``--paged`` runs across ranks on
the model axis only (data = 1); several workers run on one rank only.

Each engine decodes through the compiled step (``serve/graphs.py``): on
the card, one rank, each warm decode step is a CUDA graph's replay, as
``repro`` jits its step; on the CPU and across ranks it runs eagerly. The
log and each worker's summary give the step mode, its captures and its
replays; no flag picks the mode, as ``repro``'s CLI has none.

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --preset full --requests 4 --slots 4 --max-seq 256 --max-new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --preset full \\
        --quantize int4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --device cpu \\
        --quantize int8-dynamic
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --preset full \\
        --journal artifacts/tune.jsonl --adapt --adapt-every 1 --top-k 5 --calibrate
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --preset full \\
        --paged --prefill-chunk 16 --replay poisson --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --preset full \\
        --requests 8 --workers 2 --journal artifacts/fleet.jsonl --adapt --gossip-every 2
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --arch granite-8b --preset full --mesh-model 2
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --arch granite-8b --preset full --mesh-model 2 \\
        --quantize int8-dynamic
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --arch granite-8b --preset full --mesh-model 1
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --arch granite-8b --preset full --mesh-model 2 --paged
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import os
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.configs import list_archs, preset_config
from repro_torch.core import costmodel
from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveTuner
from repro_torch.core.arch import DEFAULT_ARCH, append_arch, detect_arch
from repro_torch.core.calibrate import (
    CalibrationError,
    append_calibration,
    calibrate_db,
    machine_from_json,
)
from repro_torch.core.federate import apply_journal_db, merge_journal_shards
from repro_torch.core.gemm import list_backends
from repro_torch.core.gossip import GossipExchange
from repro_torch.core.policies import DEFAULT_TILE_CONFIGS, HOPPER_TILE_CONFIGS
from repro_torch.core.selector import KernelSelector, SelectorState
from repro_torch.core.tuner import Tuner, TuningDatabase, measure_wallclock
from repro_torch.dist.sharding import ShardingPlan, use_plan
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.lm import resolve_device
from repro_torch.serve import (
    AdmissionError,
    PagedServeConfig,
    PagedServeEngine,
    ServeConfig,
    ServeEngine,
)

log = logging.getLogger("repro_torch.launch.serve")


def _grid_sizes(spec):
    if not spec:
        return None
    try:
        grid = tuple(sorted({int(x) for x in spec.split(",") if x.strip()}))
    except ValueError:
        raise SystemExit(f"bad --grid-sweep {spec!r}") from None
    if not grid or min(grid) < 1:
        raise SystemExit(f"bad --grid-sweep {spec!r}")
    return grid


def shard_journal_path(journal: str, worker: int, n_workers: int) -> str:
    """Worker ``worker``'s own journal shard (the base path itself for a
    single-worker run)."""
    return journal if n_workers <= 1 else f"{journal}.shard{worker}"


def existing_journal_shards(journal: str) -> list:
    """Every journal shard a previous (possibly differently sized) fleet
    left behind, the base journal first."""
    paths = sorted(glob.glob(f"{journal}.shard*"))
    if os.path.exists(journal):
        paths.insert(0, journal)
    return paths


def replay_arrivals(n: int, pattern: str, rate: float, seed: int) -> list:
    """Arrival step of each request: ``poisson`` draws exponential
    inter-arrival gaps at ``rate`` requests a step; ``bursty`` emits
    back-to-back bursts of 4-12 separated by long idle gaps."""
    rng = np.random.default_rng(seed + 1)
    if pattern == "poisson":
        return [int(t) for t in np.floor(np.cumsum(rng.exponential(1.0 / rate, n)))]
    steps: list = []
    t = 0.0
    while len(steps) < n:
        burst = int(rng.integers(4, 13))
        steps.extend(int(t) for _ in range(min(burst, n - len(steps))))
        t += rng.exponential(burst / rate) + 1.0
    return steps


def replay_stream(engine, prompts, *, pattern, rate, seed, max_new, temperature, gossip=None,
                  gossip_every=0):
    """Drive ``engine`` on a synthetic arrival process: one engine step per
    clock tick, submissions offered as they come due, queue backpressure
    (:class:`AdmissionError`) offered again next tick. With a
    :class:`GossipExchange`, the siblings' journal shards are polled every
    ``gossip_every`` ticks and once at the drain. Returns the finished
    requests."""
    arrivals = replay_arrivals(len(prompts), pattern, rate, seed)
    tracked = []
    i = 0
    step = 0
    while i < len(prompts) or engine.outstanding():
        while i < len(prompts) and arrivals[i] <= step:
            try:
                engine.submit(prompts[i], max_new_tokens=max_new, temperature=temperature)
            except AdmissionError:
                break  # queue full: this and younger requests wait a tick
            tracked.append(engine._queue[-1])
            i += 1
        engine.step()
        step += 1
        if gossip is not None and gossip_every > 0 and step % gossip_every == 0:
            gossip.exchange()
    if gossip is not None:
        gossip.exchange()
    return [r for r in tracked if r.done]


def run_with_gossip(engine, gossip, every, max_steps: int = 10_000):
    """``EngineCore.run`` with a gossip exchange every ``every`` steps and
    one after the drain, so a worker picks up what a sibling tuned moments
    ago without restarting."""
    seen = {}
    steps = 0
    for _ in range(max_steps):
        for r in list(engine._queue) + engine.outstanding():
            seen[r.uid] = r
        if not engine.step():
            break
        steps += 1
        if every > 0 and steps % every == 0:
            gossip.exchange()
    if engine.adaptive is not None and engine.adapt_every > 0:
        engine.adaptive.drain()
    gossip.exchange()
    engine.unfinished = engine.outstanding()
    engine.exhausted = bool(engine.unfinished)
    return [r for r in seen.values() if r.done]


def warm_db(args, arch_cls: str, w: int) -> TuningDatabase:
    """Worker ``w``'s warm-start database, its own copy, as a separate
    process would load it: the snapshot, then (without ``--merge-journals``)
    the base journal and the worker's own shard of the previous fleet run,
    or (with it) the federation of every shard the fleet ever wrote."""
    if args.db and os.path.exists(args.db):
        db = TuningDatabase.load(args.db, arch=arch_cls)
    else:
        db = TuningDatabase(arch=arch_cls)
    if not args.journal:
        return db
    if args.merge_journals:
        shards = existing_journal_shards(args.journal)
        if shards:
            # last-writer-wins among the shards, then applied ON TOP of the
            # snapshot (journals post-date it)
            merged, rep = merge_journal_shards(shards, into=TuningDatabase(arch=arch_cls),
                                               missing_ok=True)
            apply_journal_db(db, merged)
            log.info("federated warm start: %d shards -> %d records (%d conflicts, %d "
                     "superseded, %d load errors)", rep.sources, len(db.records),
                     rep.conflicts, rep.superseded, rep.load_errors)
        return db
    db.replay_journal(args.journal, missing_ok=True)
    own = shard_journal_path(args.journal, w, args.workers)
    if own != args.journal:
        # a repeated fleet run must not cold-start: each worker at least
        # replays what it learned itself last time
        db.replay_journal(own, missing_ok=True)
        siblings = [p for p in existing_journal_shards(args.journal)
                    if p not in (args.journal, own)]
        if siblings:
            log.info("worker %d: %d sibling journal shards exist but --merge-journals is "
                     "off; pass it to warm-start from the whole fleet", w, len(siblings))
    return db


def build_worker(args, device, w: int = 0):
    """The selector (and, with ``--adapt``, its :class:`AdaptiveTuner`) of
    worker ``w``: warm start from ``--db`` and the journal (``warm_db``),
    the calibration (replayed, or fitted with ``--calibrate``), the sieve
    built from the warm records, one :class:`SelectorState`; commits go to
    the worker's own journal shard. Returns ``(selector, adaptive)``; the
    selector is None (the device's default) when no tuning flag is given."""
    on_card = device.type == "cuda"
    mach = costmodel.H100 if on_card else costmodel.V5E
    tiles = HOPPER_TILE_CONFIGS if on_card else DEFAULT_TILE_CONFIGS
    if args.mach_json:
        try:
            with open(args.mach_json) as f:
                mach = machine_from_json(json.load(f), base=mach)
        except (OSError, ValueError, TypeError) as e:
            raise SystemExit(f"bad --mach-json {args.mach_json!r}: {e}") from None
        log.info("machine overrides: peak=%.1f TF/s bw=%.0f GB/s lanes=%d",
                 mach.peak_flops / 1e12, mach.hbm_bw / 1e9, mach.lanes)
    grid_sizes = _grid_sizes(args.grid_sweep)
    arch_profile = None
    arch_cls = DEFAULT_ARCH
    if args.arch_class == "auto":
        arch_profile = detect_arch(mach)
        arch_cls = arch_profile.cls
        log.info("arch class: %s", arch_cls)
    if not (args.db or args.journal or args.adapt or args.calibrate or args.mach_json
            or grid_sizes or arch_profile):
        return None, None
    journal = shard_journal_path(args.journal, w, args.workers) if args.journal else None
    db = warm_db(args, arch_cls, w)
    # a calibration replayed from the journal/snapshot warm-starts
    # model-first dispatch even without --calibrate
    calibration = db.calibration
    if args.calibrate:
        try:
            db.set_calibration(calibrate_db(db, base=mach))
        except CalibrationError as e:
            log.warning("worker %d: calibration skipped: %s", w, e)
        else:
            calibration = db.calibration
            if journal:
                append_calibration(journal, calibration)
    sieve = db.build_sieve() if db.n_records() else None
    selector = KernelSelector(
        mach=mach, tile_configs=tiles, grid_sizes=grid_sizes,
        state=SelectorState(db=db, sieve=sieve, calibration=calibration, arch=arch_cls),
    )
    log.info("worker %d warm start: %d tuned records + %d cross-arch (%d dropped at load), "
             "calibration %s, arch %s", w, len(db.records), db.n_records() - len(db.records),
             db.load_errors, "installed" if calibration is not None else "absent", arch_cls)
    if arch_profile is not None and journal:
        # declare this producer's coordinates, so every consumer of the
        # journal knows the machine behind the class
        append_arch(journal, arch_profile)
    adaptive = None
    if args.adapt:
        cfg = AdaptiveConfig(budget_s=args.adapt_budget, hot_threshold=args.adapt_threshold,
                             top_k=args.top_k)
        # on the card each candidate is timed on the kernels; on the CPU the
        # adaptive tuner's default, the analytical model, stands in
        tuner = None
        if on_card:
            tuner = Tuner(policies=selector.policies, tile_configs=selector.tile_configs,
                          measure_fn=measure_wallclock(device=device), mach=mach,
                          grid_sizes=selector.grid_sizes, top_k=args.top_k,
                          calibration=calibration, arch=arch_cls)
        adaptive = AdaptiveTuner(selector, tuner=tuner, config=cfg, journal=journal)
    return selector, adaptive


def _pct(a, q):
    return a[min(len(a) - 1, int(q / 100 * len(a)))]


def main(argv=None) -> int:
    """Parse arguments, build the model, serve the requests; 0 when all finished."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--preset", default="reduced", choices=["full", "reduced", "100m"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (the paged engine's max_active)")
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the prompts, sampling and the arrivals")
    ap.add_argument("--dtype", default=None, help="model dtype (default: the config's own)")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--backend", default=None, choices=list_backends(),
                    help="default: cuda on a CUDA device, torch on the CPU")
    ap.add_argument(
        "--quantize", default="none", choices=["none", "int8", "int8-dynamic", "int4"],
        help="weight quantization at load: the projection weights become "
        "QuantizedTensors (per-output-channel symmetric scales, dequant fused into "
        "the GEMM kernels). 'int8' keeps float activations ('<act>*int8' "
        "fingerprints); 'int8-dynamic' also quantizes activations per row at "
        "dispatch ('int8*int8', int32 MAC); 'int4' packs weights two nibbles per "
        "byte along K ('<act>*int4')",
    )
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged-KV engine (page-pool memory, admission "
                    "control, optional chunked prefill) instead of the dense slot engine")
    ap.add_argument("--page-size", type=int, default=16, help="KV rows per page (with --paged)")
    ap.add_argument("--max-pages", type=int, default=0,
                    help="page-pool size; 0 sizes it to the dense engine's KV rows "
                    "(slots * max-seq / page-size) for an equal-memory comparison")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts in chunks of this many tokens, one chunk per "
                    "engine step (0: whole-prompt prefill; with --paged)")
    ap.add_argument("--replay", default="off", choices=["off", "poisson", "bursty"],
                    help="offer the requests on a synthetic arrival process instead of all "
                    "up front, and log the per-request SLO summary")
    ap.add_argument("--replay-rate", type=float, default=1.0,
                    help="mean arrivals per engine step for --replay")
    ap.add_argument("--db", default=None,
                    help="tuning database snapshot to warm-start the selector from")
    ap.add_argument("--journal", default=None,
                    help="append-only tuning journal: replayed on start, appended to by "
                    "--adapt commits and the --calibrate fit (per-worker shards "
                    "<journal>.shard<i> when --workers > 1)")
    ap.add_argument("--workers", type=int, default=1,
                    help="serve through K engines with separate selector and tuner state, "
                    "each journaling to its own shard, one after another")
    ap.add_argument("--merge-journals", action="store_true",
                    help="federate every existing journal shard (<journal> and "
                    "<journal>.shard*) into each worker's warm-start database")
    ap.add_argument("--mesh-model", type=int, default=0,
                    help="install a (data, model=N) host-mesh sharding plan so dispatch "
                    "fingerprints key on the per-shard local MNK (0: no plan)")
    ap.add_argument("--gossip-every", type=int, default=0,
                    help="poll the sibling workers' journal shards every N engine steps and "
                    "fold fresh commits into the live selector (0: off; needs --journal)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit a CalibratedMachine from the warm-start records before "
                    "serving (robust least-squares per dtype profile over journaled wall "
                    "clocks); unseen fingerprints then dispatch from the model's argmin "
                    "('model' source) and the fit is journaled for the next run")
    ap.add_argument("--top-k", type=int, default=None,
                    help="budgeted adaptation sweeps: measure only the cost model's top-k "
                    "ranked candidates per hot fingerprint")
    ap.add_argument("--mach-json", default=None,
                    help="JSON file of Machine field overrides (e.g. "
                    '\'{"peak_flops": 8e14}\') of the machine scoring, tuning and '
                    "calibration run against (default: the nominal H100 on the card, "
                    "TPU-v5e on the CPU)")
    ap.add_argument("--arch-class", default="off", choices=["off", "auto"],
                    help="'auto' stamps tuning records with the live device's class "
                    "(detect_arch), so records are direct hits only within it; 'off': the "
                    "single class 'default'")
    ap.add_argument("--grid-sweep", default=None,
                    help="comma-separated grid sizes the selector and tuner sweep with "
                    "(policy, tile), e.g. '66,132,264' (default: {lanes/2, lanes, 2*lanes})")
    ap.add_argument("--adapt", action="store_true",
                    help="online miss-driven autotuning in the decode loop (on the card "
                    "it times the hand-written kernels)")
    ap.add_argument("--adapt-every", type=int, default=4,
                    help="decode steps between adaptation rounds (with --adapt)")
    ap.add_argument("--adapt-budget", type=float, default=None,
                    help="wallclock seconds per adaptation round (default: uncapped)")
    ap.add_argument("--adapt-threshold", type=int, default=1,
                    help="misses before a fingerprint is tuned; the port counts one per "
                    "dispatch, where the JAX package counts one per trace")
    ap.add_argument("--summary-json", default=None,
                    help="write the run's summary (requests, per-worker timing, pool and "
                    "SLO figures, selection sources, gossip and federation counts) here")
    args = ap.parse_args(argv)
    if args.workers < 1:
        raise SystemExit(f"--workers must be >= 1, got {args.workers}")
    if args.merge_journals and not args.journal:
        raise SystemExit("--merge-journals requires --journal")
    if args.gossip_every < 0:
        raise SystemExit(f"--gossip-every must be >= 0, got {args.gossip_every}")
    if args.gossip_every and not args.journal:
        raise SystemExit("--gossip-every requires --journal")
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = preset_config(args.arch, args.preset)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if cfg.family == "encdec":
        raise SystemExit("serve CLI drives decoder-only archs; see examples/ for enc-dec")
    joined = join_ranks(args)
    device = resolve_device(args.device)
    if device.type == "cuda" and joined:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    plan = None
    if args.mesh_model:
        mesh = make_host_mesh(model=args.mesh_model)
        plan = ShardingPlan(mesh)
        log.info("mesh plan installed: %s -> gemm divisors %s", mesh.shape, plan.gemm_div())
    model = build_model(cfg)
    t0 = time.perf_counter()
    with use_plan(plan):
        params = model.init_params(device,
                                   torch.Generator(device=device).manual_seed(args.seed))
    log.info("built %s (%s, %s) on %s in %.1fs", cfg.name, args.preset, cfg.dtype, device,
             time.perf_counter() - t0)
    if args.quantize != "none":
        bits = 4 if args.quantize == "int4" else 8
        act_bits = 8 if args.quantize == "int8-dynamic" else None
        t0 = time.perf_counter()
        with use_plan(plan):  # across ranks, every rank quantizes its shards together
            params, n_quant, n_skipped = model.quantize_weights(params, bits=bits,
                                                                act_bits=act_bits)
        log.info("quantized %d weight leaves to int%d (per-output-channel scales%s) in "
                 "%.1fs; %d float leaves skipped", n_quant, bits,
                 ", dynamic int8 activations" if act_bits else "",
                 time.perf_counter() - t0, n_skipped)

    # a deterministic request stream, dealt round-robin across the workers;
    # prompt lengths respect the cache bound (submit() rejects len > max_seq)
    rng = np.random.default_rng(args.seed)
    p_hi = min(64, args.max_seq + 1)
    p_lo = min(8, p_hi - 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(p_lo, p_hi)))
               for _ in range(args.requests)]

    # build every worker's state BEFORE any engine serves: a fleet's processes
    # all start from the artifacts of before the run, so worker 1 must not
    # warm-start from what worker 0 journals moments ago in this same run
    workers = [build_worker(args, device, w) for w in range(args.workers)]
    engines = []
    with use_plan(plan):
        done, runs = serve_workers(args, model, params, device, workers, prompts, engines)
    summary = dict(arch=cfg.name, preset=args.preset, dtype=cfg.dtype, device=str(device),
                   quantize=args.quantize, requests=args.requests, completed=len(done),
                   tokens=sum(len(r.out_tokens) for r in done), workers=runs)
    if plan is not None:
        summary["mesh"] = dict(shape=plan.mesh.shape, gemm_div=plan.gemm_div())
        if plan.mesh.ranked:
            from repro_torch.kernels.common import LAUNCHES

            summary["mesh"]["ranks"] = plan.mesh.size
            summary["collectives"] = decode_collectives(engines[0])
            # every rank's kernel launches over the run
            every = [None] * plan.mesh.size
            torch.distributed.all_gather_object(every, {n: c for n, c in LAUNCHES.items() if c})
            summary["launches_by_rank"] = every
    log.info("served %d/%d requests, %d tokens across %d worker(s) (rung %s, mesh %s)",
             len(done), args.requests, summary["tokens"], args.workers, args.quantize,
             None if plan is None else plan.mesh.shape)
    if args.workers > 1 and args.journal:
        # the federation summary: what the fleet learned in this run
        shard_paths = [shard_journal_path(args.journal, w, args.workers)
                       for w in range(args.workers)]
        merged, rep = merge_journal_shards(shard_paths, into=TuningDatabase(), missing_ok=True)
        summary["federation"] = dict(records=merged.n_records(), sources=rep.sources,
                                     examined=rep.examined, conflicts=rep.conflicts,
                                     superseded=rep.superseded, load_errors=rep.load_errors)
        log.info("fleet journals federate to %d records (%d shards, %d conflicts); re-run "
                 "with --merge-journals to warm-start every worker from them",
                 merged.n_records(), rep.sources, rep.conflicts)
    if args.summary_json and (not joined or torch.distributed.get_rank() == 0):
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1)
    if joined:
        torch.distributed.destroy_process_group()
    return 0 if len(done) == args.requests else 1


def join_ranks(args) -> bool:
    """Join the process group ``torch.distributed.run`` describes (its
    environment: ``WORLD_SIZE`` > 1) over ``gloo``, for ``--mesh-model``;
    refuse what does not run across them (module doc). Returns whether this
    process joined."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return False
    if not args.mesh_model:
        raise SystemExit(f"{world} ranks need --mesh-model (the model axis they split)")
    if world % args.mesh_model:
        raise SystemExit(f"{world} ranks do not split into (data, model = {args.mesh_model})")
    if args.workers > 1:
        raise SystemExit("--workers runs on one rank: across ranks one engine a rank serves")
    if args.paged and world > args.mesh_model:
        raise SystemExit(f"--paged across ranks splits the model axis only: --mesh-model "
                         f"{args.mesh_model} over {world} ranks would put "
                         f"{world // args.mesh_model} on data, which would split the page pool")
    import torch.distributed as dist

    dist.init_process_group("gloo")
    logging.getLogger().handlers[0].setFormatter(
        logging.Formatter(f"[rank {dist.get_rank()}] %(message)s"))
    return True


def decode_collectives(engine) -> dict:
    """The collectives of one decode step (every step runs the same ones
    at a fixed slot count), and the host ms the decode steps and the
    collectives inside them took, summed over the run."""
    steps = engine.timing["decode_steps"]
    coll = engine.decode_collectives
    per_step = {op: {"count": c // max(steps, 1), "bytes": b // max(steps, 1)}
                for op, (c, b) in sorted(coll.per_op.items())}
    uneven = [op for op, (c, _) in coll.per_op.items() if steps and c % steps]
    return dict(decode_steps=steps, per_decode_step=per_step, uneven_ops=uneven,
                total=coll.summary(), decode_ms=engine.timing["decode_s"] * 1e3,
                collective_ms=coll.seconds * 1e3)


def serve_workers(args, model, params, device, workers, prompts, engines=None):
    """Serve ``prompts`` (dealt round-robin) through one engine per worker,
    one worker after another; returns (finished requests, each worker's
    summary), and appends each engine to ``engines``. Engines are built
    here, so under an installed plan they take its GEMM divisors."""
    done, runs = [], []
    for w, (selector, adaptive) in enumerate(workers):
        gossip = None
        if args.gossip_every and args.workers > 1:
            # each worker tails every OTHER worker's shard: its own commits
            # are already in its database
            peers = [shard_journal_path(args.journal, x, args.workers)
                     for x in range(args.workers) if x != w]
            gossip = GossipExchange(selector, peers)
        kw = dict(selector=selector, backend=args.backend, device=device, adaptive=adaptive,
                  adapt_every=args.adapt_every if args.adapt else 0)
        if args.paged:
            max_pages = args.max_pages or args.slots * args.max_seq // args.page_size
            engine = PagedServeEngine(model, params, PagedServeConfig(
                page_size=args.page_size, max_pages=max_pages, max_active=args.slots,
                max_seq=args.max_seq, prefill_chunk=args.prefill_chunk, eos=-1,
                seed=args.seed), **kw)
        else:
            engine = ServeEngine(model, params, ServeConfig(
                n_slots=args.slots, max_seq=args.max_seq, eos=-1, seed=args.seed), **kw)
        wprompts = prompts[w :: args.workers]
        if args.replay != "off":
            served = replay_stream(engine, wprompts, pattern=args.replay, rate=args.replay_rate,
                                   seed=args.seed + w, max_new=args.max_new_tokens,
                                   temperature=args.temperature, gossip=gossip,
                                   gossip_every=args.gossip_every)
            if adaptive is not None:
                # replay drives step() directly; flush what run() would have
                # committed at the end of its drain
                adaptive.drain()
        else:
            for prompt in wprompts:
                engine.submit(prompt, max_new_tokens=args.max_new_tokens,
                              temperature=args.temperature)
            if gossip is not None:
                served = run_with_gossip(engine, gossip, args.gossip_every)
            else:
                served = engine.run()
        done.extend(served)
        runs.append(_worker_summary(w, engine, served, wprompts, gossip, args))
        if engines is not None:
            engines.append(engine)
    return done, runs


def _worker_summary(w, engine, served, prompts, gossip, args) -> dict:
    """Log one worker's run (timing, pool, SLO, selector, adaptation,
    gossip, its dispatch decisions) and return it as a dict."""
    tm = engine.timing
    log.info(
        "worker %d served %d/%d requests: prefill %d tokens in %.3fs (%.1f tok/s), decode "
        "%d tokens in %d steps, %.3fs (%.1f tok/s)", w, len(served), len(prompts),
        tm["prefill_tokens"], tm["prefill_s"], tm["prefill_tokens"] / max(tm["prefill_s"], 1e-9),
        tm["decode_tokens"], tm["decode_steps"], tm["decode_s"],
        tm["decode_tokens"] / max(tm["decode_s"], 1e-9),
    )
    step = engine.decode
    log.info("worker %d decode step mode %s: %d capture(s), %d replay(s)", w, step.mode,
             len(step.captured), step.replays)
    out = dict(worker=w, completed=len(served), requests=len(prompts), backend=engine.backend,
               timing=dict(tm), prompts=[p.tolist() for p in prompts],
               out_tokens=[list(r.out_tokens) for r in sorted(served, key=lambda r: r.uid)],
               step_mode=step.mode, captures=len(step.captured), replays=step.replays)
    if args.paged:
        m = engine.metrics()
        out["pool"] = m
        log.info("worker %d paged pool: peak %d/%d pages, peak %d resident, %d admitted / %d "
                 "rejected / %d truncated, %d stall events", w, m["peak_used_pages"],
                 m["n_pages"], m["peak_resident"], m["admitted"], m["rejected"],
                 m["truncated"], m["stall_events"])
        if args.replay != "off" and served:
            lat = sorted(r.done_step - r.submit_step for r in served)
            ttft = sorted(r.first_token_step - r.submit_step for r in served)
            out["slo_steps"] = dict(latency_p50=_pct(lat, 50), latency_p99=_pct(lat, 99),
                                    ttft_p50=_pct(ttft, 50), ttft_p99=_pct(ttft, 99))
            log.info("worker %d SLO (steps): latency p50=%d p99=%d, ttft p50=%d p99=%d over "
                     "%d completed requests", w, _pct(lat, 50), _pct(lat, 99),
                     _pct(ttft, 50), _pct(ttft, 99), len(served))
    st = engine.dispatch_stats
    log.info("worker %d selector: %d lookups, %d cache hits, %d tuned, %d sieve, %d "
             "model-warm, %d fallbacks (backend %s)", w, st.lookups, st.cache_hits,
             st.tuned_hits, st.sieve_hits, st.model_warm, st.fallbacks, engine.backend)
    if engine.adaptive is not None:
        log.info("worker %d adaptation: %d misses (%d model-warm, %d xarch-seeded) -> %d "
                 "records committed (sieve generation %d, %d pending, db=%d records)", w,
                 st.misses, st.model_warm, st.xarch_seeds, st.adaptations,
                 st.sieve_generation, st.pending_hot, st.db_records)
        out["adaptations"] = st.adaptations
    if gossip is not None:
        gs = gossip.stats
        out["gossip"] = dict(rounds=gs.rounds, polls=gs.polls, entries=gs.entries,
                             swaps=gs.swaps, load_errors=gs.load_errors)
        log.info("worker %d gossip: %d rounds, %d sibling entries absorbed over %d hot-swaps "
                 "(%d load errors)", w, gs.rounds, gs.entries, gs.swaps, gs.load_errors)
    # selection sources of every dispatch, and of the decode dispatches
    # (M = the decode width)
    out["sources"] = dict(Counter(e.selection.source for e in engine.selection_log))
    out["decode_sources"] = dict(Counter(e.selection.source for e in engine.selection_log
                                         if not e.op.fused and e.local_mnk[0] == args.slots))
    seen = {}
    for e in engine.selection_log:
        seen.setdefault((e.tag, e.op.g_local, e.local_mnk, e.op.in_dtype), e.selection)
    for (tag, groups, mnk, dtypes), sel in sorted(seen.items()):
        log.info("  %-10s %sM,N,K=%s %s -> %s/%s g=%d (%s)", tag,
                 f"G={groups} " if groups > 1 else "", mnk, dtypes, sel.policy.name,
                 sel.cfg.name, sel.g, sel.source)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
