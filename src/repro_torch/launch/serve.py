"""Serve an LM through the port: ``python -m repro_torch.launch.serve``.

Builds the model with random weights from a seeded ``torch.Generator``,
submits ``--requests`` seeded prompts to a :class:`ServeEngine`, drains it,
and logs throughput plus the Stream-K++ dispatch decisions the traffic made.
It runs on the CUDA device through the hand-written kernels unless
``--device cpu`` is given (then the ``torch`` backend serves, unless
``--backend cuda`` asks for the kernels' plain versions).

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --preset full --requests 4 --slots 4 --max-seq 256 --max-new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --preset full
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.gemm import list_backends
from repro_torch.models.lm import LM, resolve_device
from repro_torch.serve.engine import ServeConfig, ServeEngine

log = logging.getLogger("repro_torch.launch.serve")


def main(argv=None) -> int:
    """Parse arguments, build the model, serve the requests; 0 when all finished."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--preset", default="reduced", choices=["full", "reduced"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--backend", default=None, choices=list_backends(),
                    help="default: cuda on a CUDA device, torch on the CPU")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = get_config(args.arch) if args.preset == "full" else get_reduced(args.arch)
    device = resolve_device(args.device)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init_params(device, torch.Generator(device=device).manual_seed(0))
    log.info("built %s (%s) on %s in %.1fs", cfg.name, args.preset, device,
             time.perf_counter() - t0)

    engine = ServeEngine(
        model,
        params,
        ServeConfig(n_slots=args.slots, max_seq=args.max_seq, eos=-1),
        backend=args.backend,
        device=device,
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
    st = engine.selector_stats
    log.info("selector: %d lookups, %d cache hits, %d fallbacks (backend %s)",
             st.lookups, st.cache_hits, st.fallbacks, engine.backend)
    seen = {}
    for e in engine.selection_log:
        seen.setdefault((e.tag, e.op.g_local, e.local_mnk), e.selection)
    for (tag, groups, mnk), sel in sorted(seen.items()):
        log.info("  %-10s %sM,N,K=%s -> %s/%s g=%d (%s)", tag,
                 f"G={groups} " if groups > 1 else "", mnk, sel.policy.name, sel.cfg.name,
                 sel.g, sel.source)
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
