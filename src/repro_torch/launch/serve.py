"""Serve an LM through the port: ``python -m repro_torch.launch.serve``.

Builds the model with random weights from a seeded ``torch.Generator``,
submits ``--requests`` seeded prompts to a :class:`ServeEngine`, drains it,
and logs throughput plus the Stream-K++ dispatch decisions the traffic made.
It runs on the CUDA device through the hand-written kernels unless
``--device cpu`` is given (then the ``torch`` backend serves, unless
``--backend cuda`` asks for the kernels' plain versions). ``--quantize``
serves on a rung of the quantization ladder: the projection weights are
quantized on the serving device, one leaf (and one layer of a stacked leaf)
at a time.

Tuning artifacts (the single-worker part of the JAX package's serve CLI):
``--db`` loads a snapshot and ``--journal`` replays a journal on top of it
(and takes ``--adapt``'s commits and ``--calibrate``'s fit), ``--calibrate``
fits the cost model to the warm records' wall clocks, and the selector then
dispatches from the database, the sieve built from it and the calibration.
``--adapt`` tunes untuned fingerprints between decode steps
(``--adapt-every``, ``--adapt-threshold``, ``--adapt-budget``,
``--top-k``): on the card each candidate is timed on the hand-written
kernels, on the CPU the analytical model stands in. ``--arch-class auto``
stamps records with the live device's class, ``--grid-sweep`` and
``--mach-json`` set the grid sizes and the machine the selector scores
under (default: the nominal H100 and 66, 132, 264 on the card; TPU-v5e on
the CPU). Not ported yet: ``--workers``, ``--merge-journals`` and
``--gossip-every`` (federation, ROADMAP A5); ``--paged``, ``--replay*`` and
``--prefill-chunk`` (paged serving, ROADMAP A4).

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --preset full --requests 4 --slots 4 --max-seq 256 --max-new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --preset full \\
        --quantize int4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --device cpu \\
        --quantize int8-dynamic
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --preset full \
        --journal artifacts/tune.jsonl --adapt --adapt-every 1 --top-k 5 --calibrate
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core import costmodel
from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveTuner
from repro_torch.core.arch import DEFAULT_ARCH, append_arch, detect_arch
from repro_torch.core.calibrate import (
    CalibrationError,
    append_calibration,
    calibrate_db,
    machine_from_json,
)
from repro_torch.core.gemm import list_backends
from repro_torch.core.policies import DEFAULT_TILE_CONFIGS, HOPPER_TILE_CONFIGS
from repro_torch.core.selector import KernelSelector, SelectorState
from repro_torch.core.tuner import Tuner, TuningDatabase, measure_wallclock
from repro_torch.models.lm import LM, resolve_device
from repro_torch.serve.engine import ServeConfig, ServeEngine

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


def build_worker(args, device):
    """The selector (and, with ``--adapt``, its :class:`AdaptiveTuner`) for
    one serving process: warm start from ``--db`` and ``--journal``, the
    calibration (replayed, or fitted with ``--calibrate``), the sieve built
    from the warm records, one :class:`SelectorState`. Returns
    ``(selector, adaptive)``; the selector is None (the device's default)
    when no tuning flag is given."""
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
    if args.db and os.path.exists(args.db):
        db = TuningDatabase.load(args.db, journal=args.journal, arch=arch_cls)
    else:
        db = TuningDatabase(arch=arch_cls)
        if args.journal:
            db.replay_journal(args.journal, missing_ok=True)
    # a calibration replayed from the journal/snapshot warm-starts
    # model-first dispatch even without --calibrate
    calibration = db.calibration
    if args.calibrate:
        try:
            db.set_calibration(calibrate_db(db, base=mach))
        except CalibrationError as e:
            log.warning("calibration skipped: %s", e)
        else:
            calibration = db.calibration
            if args.journal:
                append_calibration(args.journal, calibration)
    sieve = db.build_sieve() if db.n_records() else None
    selector = KernelSelector(
        mach=mach, tile_configs=tiles, grid_sizes=grid_sizes,
        state=SelectorState(db=db, sieve=sieve, calibration=calibration, arch=arch_cls),
    )
    log.info("warm start: %d tuned records + %d cross-arch (%d dropped at load), "
             "calibration %s, arch %s", len(db.records), db.n_records() - len(db.records),
             db.load_errors, "installed" if calibration is not None else "absent", arch_cls)
    if arch_profile is not None and args.journal:
        # declare this producer's coordinates, so every consumer of the
        # journal knows the machine behind the class
        append_arch(args.journal, arch_profile)
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
        adaptive = AdaptiveTuner(selector, tuner=tuner, config=cfg, journal=args.journal)
    return selector, adaptive


def main(argv=None) -> int:
    """Parse arguments, build the model, serve the requests; 0 when all finished."""
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported yet: --workers, --merge-journals and --gossip-every (federation, "
        "ROADMAP A5); --paged, --replay* and --prefill-chunk (paged serving, ROADMAP A4).",
    )
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--preset", default="reduced", choices=["full", "reduced"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new-tokens", type=int, default=8)
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
    ap.add_argument("--db", default=None,
                    help="tuning database snapshot to warm-start the selector from")
    ap.add_argument("--journal", default=None,
                    help="append-only tuning journal: replayed on start, appended to by "
                    "--adapt commits and the --calibrate fit")
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
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = get_config(args.arch) if args.preset == "full" else get_reduced(args.arch)
    device = resolve_device(args.device)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init_params(device, torch.Generator(device=device).manual_seed(0))
    log.info("built %s (%s) on %s in %.1fs", cfg.name, args.preset, device,
             time.perf_counter() - t0)
    if args.quantize != "none":
        bits = 4 if args.quantize == "int4" else 8
        act_bits = 8 if args.quantize == "int8-dynamic" else None
        t0 = time.perf_counter()
        params, n_quant, n_skipped = model.quantize_weights(params, bits=bits,
                                                            act_bits=act_bits)
        log.info("quantized %d weight leaves to int%d (per-output-channel scales%s) in "
                 "%.1fs; %d float leaves skipped", n_quant, bits,
                 ", dynamic int8 activations" if act_bits else "",
                 time.perf_counter() - t0, n_skipped)

    selector, adaptive = build_worker(args, device)
    engine = ServeEngine(
        model,
        params,
        ServeConfig(n_slots=args.slots, max_seq=args.max_seq, eos=-1),
        selector=selector,
        backend=args.backend,
        device=device,
        adaptive=adaptive,
        adapt_every=args.adapt_every if args.adapt else 0,
    )
    rng = np.random.default_rng(0)
    p_hi = min(64, args.max_seq + 1)
    p_lo = min(8, p_hi - 1)
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=int(rng.integers(p_lo, p_hi)))
        engine.submit(prompt, max_new_tokens=args.max_new_tokens)
    done = engine.run()
    tm = engine.timing
    log.info(
        "served %d/%d requests: prefill %d tokens in %.3fs (%.1f tok/s), decode "
        "%d tokens in %d steps, %.3fs (%.1f tok/s)",
        len(done), args.requests, tm["prefill_tokens"], tm["prefill_s"],
        tm["prefill_tokens"] / max(tm["prefill_s"], 1e-9), tm["decode_tokens"],
        tm["decode_steps"], tm["decode_s"], tm["decode_tokens"] / max(tm["decode_s"], 1e-9),
    )
    st = engine.dispatch_stats
    log.info("selector: %d lookups, %d cache hits, %d tuned, %d sieve, %d model-warm, "
             "%d fallbacks (backend %s)", st.lookups, st.cache_hits, st.tuned_hits,
             st.sieve_hits, st.model_warm, st.fallbacks, engine.backend)
    if adaptive is not None:
        log.info("adaptation: %d misses (%d model-warm, %d xarch-seeded) -> %d records "
                 "committed (sieve generation %d, %d pending, db=%d records)", st.misses,
                 st.model_warm, st.xarch_seeds, st.adaptations, st.sieve_generation,
                 st.pending_hot, st.db_records)
    seen = {}
    for e in engine.selection_log:
        seen.setdefault((e.tag, e.op.g_local, e.local_mnk, e.op.in_dtype), e.selection)
    for (tag, groups, mnk, dtypes), sel in sorted(seen.items()):
        log.info("  %-10s %sM,N,K=%s %s -> %s/%s g=%d (%s)", tag,
                 f"G={groups} " if groups > 1 else "", mnk, dtypes, sel.policy.name,
                 sel.cfg.name, sel.g, sel.source)
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
