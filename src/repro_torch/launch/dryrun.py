"""Dry run of the production meshes: prove a distribution config coherent
without hardware (the port's counterpart of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell this builds the model,
its parameter specs and the sharding plan, and traces the real step on the
meta device under ``gemm_context`` and ``use_plan`` (the train step with
AdamW, forward and backward, for train shapes; ``prefill`` or
``decode_step`` against the cache specs for the others). Nothing is
allocated. It records:

  * the Stream-K++ dispatch log: every GEMM's per-shard local MNK and the
    selection made for it (the H100 selector unless told otherwise), keyed
    ``tag:local_mnk``;
  * per-device argument bytes: parameters, the optimizer state mirroring
    them, caches and inputs, each leaf at its local shape
    (``repro_torch.dist.cost``);
  * the step's FLOPs (``FlopCounterMode``), and the share the dispatch ran.
    A train cell's remat recompute runs each layer to its end (checkpoint
    early stop off), so every logged dispatch ran and both counts include
    the recompute of the layer's last GEMM, which an eager step skips.

  * the collectives one rank runs in the step, under ``repro``'s keys:
    ``collectives`` (per op ``{"count", "bytes"}``, payload bytes of each
    result at its local shape), ``collective_bytes`` (their sum) and, in
    ``cost``, ``collective_bytes`` with ``repro.dist.hlo_cost``'s x2 for an
    all-reduce and ``collective_counts``. They come from a trace of one
    rank's step on its local shards under a virtual host mesh of the same
    sizes (``launch/mesh.py virtual_mesh``) and the same rules, the cell's
    ``rules_for_cell`` plus ``--rules``, as ``repro`` lowers it: every
    collective the ranks' explicit layout (``models/layers.py``) runs,
    recorded at its local shapes without communicating
    (``dist/collectives.py``). A train cell runs sequence-parallel
    (``seq`` on ``model``): the residual stream's gathers before each
    block's column-parallel projections and the reduce-scatters of its
    row-parallel outputs, the norms' gradients summed over ``model``, and
    the optimizer's own reductions (Adafactor's factored moments). A decode
    cell's cache splits its positions over its ``kv_seq`` axes (over
    ``model`` too, with the kv heads whole, where those do not divide it):
    a layer's query all-gather over ``model`` where that carries the
    positions, and the partial softmaxes' max and sum all-reduces. The
    layers are a Python loop, so every layer's collectives are counted, the
    serving steps' as the engine's ranks run them: the logits gathered over
    the data axes where those split the batch, an MoE layer's counts
    exchange over them (its own ``moe_impl``, expert-parallel), a Mamba2
    block's projection and conv outputs gather over ``model``
    (``models/ssd.py``), a VLM's prefill takes its patch embeddings and an
    encoder-decoder's its frames. A layout the ranks do not run records
    ``None`` and why.

``mesh_shape`` of a host mesh (any size but 256 and 512, e.g. (1, 2) or
(2, 2)) traces only that local step, under the same rules: its dispatch
log, FLOPs and argument bytes are one rank's, and its collectives are what
the same cell runs on that many ``torch.distributed`` ranks under those
rules (``extra_rules`` of the ranks' own plan, e.g. ``DEFAULT_RULES``,
traces what ranks without the cell's rules run). ``repro`` also records XLA's
memory and cost analyses of the compiled program; the port has none, and
leaves those keys out. Artifacts land in
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json``.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")


def rules_for_cell(cfg, shape, mesh) -> Dict[str, Any]:
    """Cell-specific sharding-rule overrides (decode caches are the
    interesting case: shard kv-heads over 'model' when divisible, else the
    kv sequence dim; long_500k's batch=1 lets kv_seq absorb the batch axes)."""
    rules: Dict[str, Any] = {}
    model_n = mesh.shape["model"]
    if shape.kind == "train":
        # sequence parallelism for the residual stream: the per-layer remat
        # saves shard over 'model'
        rules["seq"] = "model"
    if shape.kind == "decode":
        if cfg.n_kv_heads and cfg.n_kv_heads % model_n == 0:
            rules["kv_heads"] = "model"
            rules["kv_seq"] = ("pod", "data")
        else:
            rules["kv_heads"] = None
            rules["kv_seq"] = ("pod", "data", "model")
    return rules


def _input_axes(cfg, shape) -> Dict[str, tuple]:
    if shape.kind == "train":
        axes = {
            "tokens": ("batch", None),
            "labels": ("batch", None),
            "loss_mask": ("batch", None),
        }
    elif shape.kind == "prefill":
        axes = {"tokens": ("batch", None)}
    else:
        axes = {"tokens": ("batch", None), "cur_pos": ("batch",)}
    if cfg.family == "vlm" and shape.kind != "decode":
        axes["patch_embeds"] = ("batch", None, None)
    if cfg.family == "encdec" and shape.kind != "decode":
        axes["frames"] = ("batch", "frames", None)
    return axes


def _applied_divisor(plan, aspec, dim_index=0) -> int:
    spec = plan.spec_for(aspec)
    part = spec[dim_index] if dim_index < len(spec) else None
    if part is None:
        return 1
    axes = (part,) if isinstance(part, str) else part
    d = 1
    for a in axes:
        d *= plan.mesh.shape[a]
    return d


def mesh_name(multi_pod: bool, host_shape=None) -> str:
    if host_shape is not None:
        return "host_" + "x".join(str(int(d)) for d in host_shape)
    return "multi_pod" if multi_pod else "single_pod"


def trace_local(model, cfg, shape, plan, *, selector, optimizer_name="adamw",
                microbatches=1):
    """One rank's step of the cell on its local shards (meta tensors) under
    ``plan`` over a virtual host mesh: (dispatch context, ``StepFlops``,
    ``CollectiveStats``, argument bytes)."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.data.pipeline import input_specs
    from repro_torch.dist.collectives import record
    from repro_torch.dist.cost import StepFlops, specs_like, tree_local_bytes
    from repro_torch.dist.sharding import abstract_tree, local_rows, local_specs, use_plan
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.train.trainer import init_train_state, make_train_step

    specs = model.param_specs()
    argument = 0
    with gemm_context(selector=selector) as ctx, use_plan(plan), StepFlops() as flops, \
            record() as coll:
        params = abstract_tree(local_specs(specs))
        # the serving calls take the whole batch and run this rank's rows
        full = input_specs(cfg, shape)
        ins = local_rows(full)
        argument += sum(v.numel() * v.element_size() for v in ins.values())
        argument += tree_local_bytes(plan, specs)
        if shape.kind == "train":
            optimizer = make_optimizer(optimizer_name, constant(1e-4))
            step_fn = make_train_step(model, optimizer, div={}, microbatches=microbatches)
            state = init_train_state(model, optimizer, params)
            argument += tree_local_bytes(plan, specs_like(
                state["opt"], {k: specs for k in state["opt"]}))
            # as a rank runs it: a remat recompute stops where its last saved
            # tensor is made, before the collectives that follow it
            step_fn(state, ins)
        else:
            with torch.no_grad():
                if shape.kind == "prefill" and cfg.family == "encdec":
                    model.prefill(params, full["frames"], full["tokens"], max_seq=shape.seq_len)
                elif shape.kind == "prefill":
                    kw = {"patch_embeds": full["patch_embeds"]} if "patch_embeds" in full else {}
                    model.prefill(params, full["tokens"], max_seq=shape.seq_len, **kw)
                else:
                    cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
                    argument += tree_local_bytes(plan, cache_specs)
                    model.decode_step(params, abstract_tree(local_specs(cache_specs)),
                                      full["tokens"], full["cur_pos"])
    return ctx, flops, coll, argument


def collective_keys(coll) -> Dict[str, Any]:
    """``repro``'s artifact keys of a ``CollectiveStats`` (module doc)."""
    return {"collectives": coll.summary(), "collective_bytes": coll.total_bytes}


def _dispatch_table(log) -> Dict[str, Dict[str, Any]]:
    """Unique local GEMMs and their selections, keyed ``tag:local_mnk`` (the
    first dispatch of each key: a remat recompute repeats the forward's)."""
    dispatch: Dict[str, Dict[str, Any]] = {}
    for e in log:
        key = f"{e.tag}:{e.local_mnk}"
        if key in dispatch:
            continue
        op, sel = e.op, e.selection
        dispatch[key] = {
            "local_mnk": list(e.local_mnk),
            "policy": sel.policy.name,
            "cfg": sel.cfg.name,
            "source": sel.source,
            # what launching the per-shard GEMM on its own needs
            "tile": [sel.cfg.bm, sel.cfg.bn, sel.cfg.bk],
            "g": sel.g,
            "kind": op.kind,
            "groups": op.g_local,
            "fused": op.fused,
            "in_dtype": op.in_dtype,
            "out_dtype": op.out_dtype,
            "epilogue": op.epilogue.name,
            "epilogue_fields": dataclasses.asdict(op.epilogue),
            "global_mnk": list(op.global_mnk),
            "global_groups": op.g,
            "divisors": list(op.divisors),
            "g_divisor": op.g_divisor,
        }
    return dispatch


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    variant: str = "baseline",
    extra_rules: Optional[Dict[str, Any]] = None,
    mesh_shape: Optional[tuple] = None,
    microbatches: int = 1,
    config_overrides: Optional[Dict[str, Any]] = None,
    optimizer_name: str = "adamw",
    selector=None,
    shape_overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Trace one cell on the meta device (module doc); returns its artifact.
    ``selector`` defaults to the H100 one (``default_selector("cuda")``:
    the card's picks, no card needed); ``shape_overrides`` replaces fields
    of the input shape (``global_batch``, ``seq_len``)."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import dtype_name, gemm_context
    from repro_torch.core.selector import default_selector
    from repro_torch.data.pipeline import input_specs
    from repro_torch.dist.cost import StepFlops, dispatch_flops, specs_like, tree_local_bytes
    from repro_torch.dist.sharding import ArraySpec, ShardingPlan, abstract_tree, use_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import SHAPES_BY_NAME, applicable_shapes, build_model
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.train.trainer import init_train_state, make_train_step, train_gemm_div

    cfg = get_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    shape = SHAPES_BY_NAME[shape_name]
    host = mesh_shape is not None and math.prod(mesh_shape) not in (256, 512)
    name = mesh_name(multi_pod, mesh_shape if host else None)
    if shape not in applicable_shapes(cfg):
        return {
            "arch": arch,
            "shape": shape_name,
            "mesh": name,
            "variant": variant,
            "status": "skipped",
            "reason": "shape not applicable (long_500k needs sub-quadratic decode)",
        }
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    if selector is None:
        selector = default_selector("cuda")

    t0 = time.time()
    if host:
        return _lower_host_cell(arch, cfg, shape, variant, mesh_shape, extra_rules,
                                microbatches, config_overrides, optimizer_name, selector, t0)
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    rules = rules_for_cell(cfg, shape, mesh)
    if extra_rules:
        rules.update(extra_rules)
    plan = ShardingPlan(mesh, rules)
    model = build_model(cfg)
    specs = model.param_specs()
    params = abstract_tree(specs)

    # gemm dispatch divisors: what one shard's GEMMs see
    ins = input_specs(cfg, shape)
    in_axes = _input_axes(cfg, shape)
    in_specs = {k: ArraySpec(tuple(v.shape), dtype_name(v.dtype), in_axes[k])
                for k, v in ins.items()}
    div = dict(train_gemm_div(model, plan=plan))
    div["batch"] = _applied_divisor(plan, in_specs["tokens"], 0)
    div.setdefault("model", mesh.shape["model"])

    argument = tree_local_bytes(plan, specs) + tree_local_bytes(plan, in_specs)
    with gemm_context(selector=selector) as ctx, use_plan(plan), StepFlops() as flops:
        if shape.kind == "train":
            optimizer = make_optimizer(optimizer_name, constant(1e-4))
            step_fn = make_train_step(model, optimizer, div=div, microbatches=microbatches)
            state = init_train_state(model, optimizer, params)
            argument += tree_local_bytes(plan, specs_like(
                state["opt"], {k: specs for k in state["opt"]}))
            argument += tree_local_bytes(plan, specs_like({"step": state["step"]}))
            # a remat recompute runs to the layer's end: with early stop a
            # recompute ends inside its last GEMM, logged but never run
            with torch.utils.checkpoint.set_checkpoint_early_stop(False):
                step_fn(state, ins)
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    if cfg.family == "encdec":
                        model.prefill(params, ins["frames"], ins["tokens"],
                                      max_seq=shape.seq_len, div=div)
                    else:
                        kw = {"patch_embeds": ins["patch_embeds"]} if "patch_embeds" in ins else {}
                        model.prefill(params, ins["tokens"], max_seq=shape.seq_len, div=div, **kw)
                else:
                    cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
                    argument += tree_local_bytes(plan, cache_specs)
                    model.decode_step(params, abstract_tree(cache_specs), ins["tokens"],
                                      ins["cur_pos"], div=div)
    t_trace = time.time() - t0

    coll_keys, coll_cost = _production_collectives(cfg, shape, mesh, rules, selector,
                                                   optimizer_name, microbatches)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": name,
        "variant": variant,
        "status": "ok",
        "n_devices": mesh.size,
        "mesh_shape": {k: int(v) for k, v in mesh.shape.items()},
        "timings_s": {"trace": round(t_trace, 3),
                      "collective_trace": round(time.time() - t0 - t_trace, 3)},
        "memory": {"argument_size": int(argument)},
        "cost": {
            "flops": float(flops.total),
            # the dispatch's share, and 2 * G * M * N * K over its log
            "gemm_flops": float(flops.dispatch),
            "gemm_flops_logged": float(dispatch_flops(ctx.log)),
            **coll_cost,
        },
        **coll_keys,
        "dispatch": _dispatch_table(ctx.log),
        "dispatches": len(ctx.log),
        "params": {
            "total": cfg.param_count(),
            "active": cfg.active_param_count(),
        },
        "config": {
            "rules": {k: list(v) if isinstance(v, tuple) else v for k, v in rules.items()},
            "div": div,
            "mesh_shape_override": list(mesh_shape) if mesh_shape else None,
            "microbatches": microbatches,
            "overrides": config_overrides or {},
            "remat": cfg.remat,
        },
    }


def _production_collectives(cfg, shape, mesh, rules, selector, optimizer_name, microbatches):
    """(artifact keys, cost keys) of the collectives one rank of a
    production cell runs (module doc): a local trace on a virtual mesh
    of the same sizes under the cell's ``rules``."""
    from repro_torch.dist.sharding import ShardingPlan
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models import build_model

    plan = ShardingPlan(virtual_mesh(mesh.sizes, mesh.axis_names), rules)
    try:
        _, _, coll, _ = trace_local(build_model(cfg), cfg, shape, plan, selector=selector,
                                    optimizer_name=optimizer_name, microbatches=microbatches)
    except NotImplementedError as e:
        return {"collectives": None, "collective_bytes": None,
                "collectives_note": f"not ported across ranks: {e}"}, {}
    return (collective_keys(coll),
            {"collective_bytes": coll.coll_bytes, "collective_counts": coll.counts()})


def _lower_host_cell(arch, cfg, shape, variant, mesh_shape, extra_rules, microbatches,
                     config_overrides, optimizer_name, selector, t0):
    """A host-mesh cell (module doc): one rank's local step only."""
    from repro_torch.dist.cost import dispatch_flops
    from repro_torch.dist.sharding import ShardingPlan
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models import build_model

    mesh = virtual_mesh(mesh_shape)
    rules = rules_for_cell(cfg, shape, mesh)
    if extra_rules:
        rules.update(extra_rules)
    plan = ShardingPlan(mesh, rules)
    ctx, flops, coll, argument = trace_local(build_model(cfg), cfg, shape, plan,
                                             selector=selector, optimizer_name=optimizer_name,
                                             microbatches=microbatches)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name(False, mesh_shape),
        "variant": variant,
        "status": "ok",
        "n_devices": mesh.size,
        "mesh_shape": {k: int(v) for k, v in mesh.shape.items()},
        "timings_s": {"trace": round(time.time() - t0, 3)},
        "memory": {"argument_size": int(argument)},
        "cost": {
            "flops": float(flops.total),
            "gemm_flops": float(flops.dispatch),
            "gemm_flops_logged": float(dispatch_flops(ctx.log)),
            "collective_bytes": coll.coll_bytes,
            "collective_counts": coll.counts(),
        },
        **collective_keys(coll),
        "dispatch": _dispatch_table(ctx.log),
        "dispatches": len(ctx.log),
        "params": {"total": cfg.param_count(), "active": cfg.active_param_count()},
        "config": {
            "rules": {k: list(v) if isinstance(v, tuple) else v for k, v in rules.items()},
            "div": {},
            "mesh_shape_override": list(mesh_shape),
            "microbatches": microbatches,
            "overrides": config_overrides or {},
            "remat": cfg.remat,
            "shape": {"global_batch": shape.global_batch, "seq_len": shape.seq_len},
        },
    }


def artifact_name(arch: str, shape: str, mesh: str, variant: str = "baseline") -> str:
    name = f"{arch}__{shape}__{mesh}"
    return name if variant == "baseline" else f"{name}__{variant}"


def run_one(args) -> int:
    art = lower_cell(
        args.arch, args.shape, args.multi_pod, args.variant,
        extra_rules=json.loads(args.rules) if args.rules else None,
        mesh_shape=tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None,
        microbatches=args.microbatches,
        config_overrides=json.loads(args.overrides) if args.overrides else None,
        optimizer_name=args.optimizer,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    name = artifact_name(args.arch, args.shape, art["mesh"], args.variant)
    with open(os.path.join(args.out_dir, name + ".json"), "w") as f:
        json.dump(art, f, indent=1)
    if art["status"] == "ok":
        print(f"[dryrun] OK {name}: trace {art['timings_s']['trace']}s, "
              f"{len(art['dispatch'])} unique GEMMs")
        print(f"  argument_size={art['memory']['argument_size']} flops={art['cost']['flops']:.4e}")
    else:
        print(f"[dryrun] SKIP {name}: {art.get('reason')}")
    return 0


def run_all(args) -> int:
    """Every (arch x shape x mesh) cell, in this process (a meta trace holds
    no memory); resumable: completed artifacts are skipped unless
    ``--force``."""
    from repro_torch.configs import list_archs
    from repro_torch.models import ALL_SHAPES

    cells = [(arch, shape.name, mp) for arch in list_archs() for shape in ALL_SHAPES
             for mp in (False, True)]
    print(f"[dryrun] {len(cells)} cells")
    failures = []
    for arch, shape, mp in cells:
        name = artifact_name(arch, shape, mesh_name(mp))
        path = os.path.join(args.out_dir, name + ".json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[dryrun] cached {name}")
                    continue
        cell = argparse.Namespace(**vars(args))
        cell.arch, cell.shape, cell.multi_pod = arch, shape, mp
        try:
            run_one(cell)
        except Exception:
            failures.append(name)
            os.makedirs(args.out_dir, exist_ok=True)
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"[dryrun] FAIL {name}; see {path}.err")
    print(f"[dryrun] done; {len(failures)} failures")
    if failures:
        print("failures:", failures)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--rules", help="JSON sharding-rule overrides")
    ap.add_argument("--mesh-shape", help="e.g. 32,8 (data,model) or 2,32,8")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--overrides", help="JSON ModelConfig field overrides")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=os.path.normpath(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    if args.all:
        return run_all(args)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    try:
        return run_one(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
