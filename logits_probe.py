#!/usr/bin/env python3
"""How far routing flips, or a deep stack's amplification of rounding, move
a model's served prefill logits on the card.

    python3 logits_probe.py <tree> [--spread] [--arch ARCH]

``<tree>`` is the root of a checkout (``.`` for this one); its
``src/repro_torch`` is imported and its kernels built at first use, so the
parent of a change can be read by the same script. The model is ``ARCH``
(olmoe-1b-7b unless given; a decoder-only arch) at full width with
``chip_smoke.py``'s seeded weights, 4 slots and its first served prompt.
One JSON line (with the card's name and power limit from ``nvidia-smi``),
every distance as max|diff| over the ``torch`` backend's max|logit|:

* ``cuda_vs_torch``: the ``cuda`` backend's prefill logits against the
  ``torch`` backend's, each routing on its own (``chip_smoke.py``'s
  reported reading), with ``expert_sets_differ``, the (layer, token) pairs
  whose top-k expert sets differ;
* ``torch_replaying_cuda``: the ``torch`` backend taking the ``cuda`` run's
  top-k choices (the reading ``chip_smoke.py`` holds), and
  ``cuda_replaying_torch``, the reverse: kernel error without the flips;
* with ``--spread``, ``torch_vs_variant``: the ``torch`` backend against
  sound variants of itself that sum K in another order (2, 4 or 8 slices
  added in f32, or in float64), each rounded once to the output type; so
  the spread routing flips give between correct implementations; and
  ``torch_vs_variant_layers``: the same variants with each decoder layer
  fed the ``torch`` run's input to it (``chip_smoke.py``'s
  ``layer_trace``), the largest over the layers of max|diff| over the
  layer's max|output|: the spread without the growth the layers after a
  layer give it (what ``chip_smoke.py`` holds for an SSM or hybrid stack).
"""

import json
import subprocess
import sys
from contextlib import contextmanager

tree = sys.argv[1]
sys.path.insert(0, f"{tree}/src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import gemm as gemm_mod  # noqa: E402
from repro_torch.core.gemm import gemm, gemm_context, register_backend  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402


@contextmanager
def routing(replay=None):
    """Record each MoE layer's top-k choice (a (T, k) index tensor per
    layer); with ``replay``, make each layer take those choices in place of
    its own, its gates its own probabilities at them."""
    routes, moe_apply = [], layers.moe_apply
    queue = None if replay is None else iter(replay)

    def wrapped(p, x, cfg, *, div):
        logits = gemm(x.reshape(-1, x.shape[-1]).float(), p["router"], tag="moe.router")
        routes.append(torch.topk(torch.softmax(logits, -1), cfg.top_k, dim=-1).indices)
        if queue is None:
            return moe_apply(p, x, cfg, div=div)
        idx = next(queue)
        topk = torch.topk
        torch.topk = lambda probs, k, dim=-1: (probs.gather(dim, idx), idx)
        try:
            return moe_apply(p, x, cfg, div=div)
        finally:
            torch.topk = topk

    layers.moe_apply = wrapped
    try:
        yield routes
    finally:
        layers.moe_apply = moe_apply


def sets_differ(routes_a, routes_b):
    return sum(int((torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1).sum())
               for a, b in zip(routes_a, routes_b))


def k_order_variant(parts, acc_dtype=torch.float32):
    """The torch backend with float GEMMs summed over K in ``parts`` slices
    (in ``acc_dtype``), then the epilogue and one rounding."""
    base = gemm_mod._torch_backend

    def run(x, w, *, op, **kw):
        if not (x.is_floating_point() and w.is_floating_point() and kw.get("b_bits", 8) == 8):
            return base(x, w, op=op, **kw)
        k = x.shape[-1]
        cuts = [k * i // parts for i in range(parts + 1)]
        acc = sum(torch.matmul(x[..., a:b].to(acc_dtype), w[..., a:b, :].to(acc_dtype))
                  for a, b in zip(cuts, cuts[1:])).to(torch.float32)
        bias = kw["bias"]
        acc = op.epilogue.apply(acc, bias=None if bias is None else bias[:, None, :],
                                operand=kw["operand"])
        return acc.to(gemm_mod.as_dtype(op.out_dtype))

    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("logits_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = sys.argv[sys.argv.index("--arch") + 1] if "--arch" in sys.argv else "olmoe-1b-7b"
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)  # chip_smoke.py's serve_prompts
    prompt = rng.integers(1, cfg.vocab_size, size=int(rng.integers(16, 65)))
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    engine = ServeEngine(model, params, ServeConfig(n_slots=4, max_seq=256, eos=-1),
                         backend="cuda")

    def torch_prefill(backend="torch"):
        with gemm_context(backend=backend):
            return model.prefill(params, tokens)[0]

    with routing() as r_cuda:
        got = engine.prefill_logits(prompt)
    with routing() as r_torch:
        want = torch_prefill()
    with routing(r_cuda):
        want_replayed = torch_prefill()
    with routing(r_torch):
        got_replayed = engine.prefill_logits(prompt)
    scale = want.float().abs().max().item()

    def dist(x, y):
        return (x.float() - y.float()).abs().max().item() / scale

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = dict(tree=tree, arch=arch, device=torch.cuda.get_device_name(0), card=card,
               max_logit=scale,
               cuda_vs_torch=dist(got, want), expert_sets_differ=sets_differ(r_cuda, r_torch),
               torch_replaying_cuda=dist(got, want_replayed),
               cuda_replaying_torch=dist(got_replayed, want))
    if "--spread" in sys.argv:
        sys.path.insert(0, tree)
        from chip_smoke import layer_trace

        with layer_trace() as trace:
            torch_prefill()
        spread, layered = {}, {}
        for name, parts, acc in (("k_in_2", 2, torch.float32), ("k_in_4", 4, torch.float32),
                                 ("k_in_8", 8, torch.float32), ("f64_acc", 1, torch.float64)):
            register_backend(f"torch_{name}", k_order_variant(parts, acc), overwrite=True)
            spread[name] = dist(torch_prefill(f"torch_{name}"), want)
            with layer_trace(replay=trace) as mine:
                torch_prefill(f"torch_{name}")
            layered[name] = max(((a[1].float() - b[1].float()).abs().max()
                                 / a[1].float().abs().max()).item()
                                for a, b in zip(trace, mine))
        out["torch_vs_variant"] = spread
        out["torch_vs_variant_layers"] = layered
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
