"""Tune the paper's GEMM suite through the port: ``python -m repro_torch.launch.tune``.

The counterpart of the JAX package's ``examples/tune_gemm.py``: sweep
(policy x tile x grid size) over the 923-size suite (every ``--stride``-th
size), keep each size's winner, build the Open-sieve from the winners, write
its C++ header and print the headline statistics, in the same lines.

On the CUDA device (the default) each candidate is timed on the port's
hand-written kernels (``measure_wallclock``: 50 warm-up and 50 timed
launches between CUDA events) and ranked under the nominal
:data:`~repro_torch.core.costmodel.H100` with the Hopper tile set and the
H100's grid sizes (66, 132, 264). With ``--device cpu`` the analytical model
under TPU-v5e constants and the default tiles stands in for the clock, as
in the JAX package, and the records equal ``repro``'s.

``--workers N`` shards the sweep across N simulated workers: each tunes a
disjoint slice of the suite into its own journal shard (one after another,
on the one device), and ``merge_journal_shards`` folds the shards back into
the single-worker database, as the JAX package's ``--workers`` does.

``--top-k 5`` measures only the cost model's top-5 ranked candidates per
size (plus DP's best-ranked and one second policy), ``--calibrate`` fits a
CalibratedMachine from the sweep's records (journaled with ``--journal`` so
serving runs warm-start model-first dispatch from it), and ``--mach-json``
overrides the nominal Machine constants from a JSON field dict. The extra
lines after the JAX package's report the winners by grid size, the sieve's
elimination rate over the tuned sizes, and each winner's model rank under
the nominal machine and under the calibration.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.tune --stride 8 --top-k 5 \\
        --calibrate --journal artifacts/tune.jsonl
    PYTHONPATH=src python -m repro_torch.launch.tune --device cpu --stride 64
    PYTHONPATH=src python -m repro_torch.launch.tune --stride 8 --workers 4
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import Counter

from repro_torch.configs.gemm_suite import suite
from repro_torch.core import costmodel
from repro_torch.core.calibrate import (
    CalibrationError,
    append_calibration,
    calibrate_db,
    key_dtypes,
    machine_from_json,
)
from repro_torch.core.federate import merge_journal_shards
from repro_torch.core.policies import DEFAULT_TILE_CONFIGS, HOPPER_TILE_CONFIGS
from repro_torch.core.tuner import Tuner, _key_shape, measure_wallclock


def model_ranks(db, tuner, calibration=None):
    """Each winner's 1-based rank under ``tuner``'s machine, or under the
    calibration's fitted machines when one is given (-1: unranked)."""
    saved = tuner.calibration
    tuner.calibration = calibration
    try:
        return [
            tuner._model_rank(_key_shape(key, key), key_dtypes(key), r.policy, r.cfg, r.g)
            for key, r in db.records.items()
        ]
    finally:
        tuner.calibration = saved


def main(argv=None) -> int:
    """Parse arguments, tune, report; 0 on success."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("artifacts", "opensieve.hpp"),
                    help="the sieve's C++ header (default: artifacts/opensieve.hpp)")
    ap.add_argument("--stride", type=int, default=1, help="suite subsample stride")
    ap.add_argument("--workers", type=int, default=1,
                    help="shard the sweep across N simulated workers and merge journals")
    ap.add_argument("--journal", default=None,
                    help="append each record (and the --calibrate fit) to this JSONL "
                    "tuning journal")
    ap.add_argument("--top-k", type=int, default=None,
                    help="budgeted sweep: measure only the cost model's top-k ranked "
                    "candidates per size (default: the exhaustive oracle sweep)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit a CalibratedMachine from the sweep's records and report "
                    "the fitted terms (appended to --journal when set)")
    ap.add_argument("--mach-json", default=None,
                    help="JSON file of Machine field overrides the sweep measures under")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): time the hand-written kernels on the card; "
                    "cpu: the analytical model under TPU-v5e constants")
    args = ap.parse_args(argv)
    if args.workers < 1:
        raise SystemExit(f"--workers must be >= 1, got {args.workers}")

    on_card = args.device == "cuda"
    mach = costmodel.H100 if on_card else costmodel.V5E
    if args.mach_json:
        with open(args.mach_json) as f:
            mach = machine_from_json(json.load(f), base=mach)
        print(
            f"machine overrides: peak={mach.peak_flops / 1e12:.1f} TF/s "
            f"bw={mach.hbm_bw / 1e9:.0f} GB/s lanes={mach.lanes}"
        )

    sizes = suite()[:: args.stride]
    t0 = time.time()
    if on_card:
        import torch

        print(f"device: {torch.cuda.get_device_name(0)}")
        tuner = Tuner(tile_configs=HOPPER_TILE_CONFIGS, measure_fn=measure_wallclock(),
                      mach=mach, top_k=args.top_k)
    else:
        tuner = Tuner(tile_configs=DEFAULT_TILE_CONFIGS, mach=mach, top_k=args.top_k)
    if args.workers > 1:
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for i in range(args.workers):
                p = os.path.join(tmp, f"shard{i}.jsonl")
                tuner.tune(sizes, shard=(i, args.workers), journal=p)
                paths.append(p)
            db, report = merge_journal_shards(paths)
        print(
            f"federated: {args.workers} worker shards merged to "
            f"{len(db.records)} records ({report.conflicts} conflicts)"
        )
    else:
        db = tuner.tune(sizes, journal=args.journal)
    print(
        f"tuned {len(sizes)} sizes in {time.time() - t0:.1f}s "
        f"({tuner.measurements} measurements"
        + (f", top-k={args.top_k} budget)" if args.top_k else ", full sweep)")
    )

    if args.calibrate:
        try:
            db.set_calibration(calibrate_db(db, base=mach))
        except CalibrationError as e:
            print(f"calibration skipped: {e}")
        else:
            cm = db.calibration
            for pk, m in cm.profiles:
                print(
                    f"calibrated profile {pk}: peak={m.peak_flops / 1e12:.1f} "
                    f"TF/s bw={m.hbm_bw / 1e9:.0f} GB/s "
                    f"launch={m.launch_overhead_s * 1e6:.2f}us "
                    f"fixup={m.fixup_serial_s * 1e6:.2f}us"
                )
            print(
                f"calibration: {cm.n_records} records, median |rel resid| "
                f"{cm.residual:.4f}"
            )
            if args.journal:
                append_calibration(args.journal, cm)
                print(f"calibration journaled to {args.journal}")

    wins = {}
    for r in db.records.values():
        wins[r.policy] = wins.get(r.policy, 0) + 1
    total = len(sizes)
    sk = sum(v for k, v in wins.items() if k != "dp")
    print(f"winners: {dict(sorted(wins.items()))}")
    print(f"data-parallel optimal: {(total - sk) / total:.1%} (paper: ~87%)")
    print(f"stream-k-based optimal: {sk / total:.1%} (paper: ~13%)")

    sieve = db.build_sieve()
    print("true-negative rate:", sieve.validate_true_negative_rate(db.winners()))
    hdr = sieve.encode_cpp_header()
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(hdr)
    print(f"C++ header artifact: {args.out} ({len(hdr)} bytes, "
          f"{len(hdr) / max(len(sizes), 1):.0f} B/size pre-compression)")

    # the port's extra lines: grid sizes, sieve pruning, model ranks
    print(f"winners by g: {dict(sorted(Counter(r.g for r in db.records.values()).items()))}")
    for key in db.records:
        sieve.candidates(key, arch=db.arch)
    print(f"sieve elimination rate over the tuned sizes: {sieve.stats.elimination_rate:.4f}")
    nominal = model_ranks(db, tuner)
    print(f"winner model_rank under the nominal machine: {dict(sorted(Counter(nominal).items()))}")
    if db.calibration is not None:
        fitted = model_ranks(db, tuner, db.calibration)
        print(f"winner model_rank under the calibration: {dict(sorted(Counter(fitted).items()))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
