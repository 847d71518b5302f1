"""The rank side of ``tests/test_torch_multirank_serve.py``: what each
``gloo`` rank runs. It holds no tests and imports neither jax nor the JAX
package (``torch.multiprocessing`` imports it in every rank it starts).

Each program reads ``inputs.pkl`` (numpy parameter trees, prompts and
batches the test wrote), runs the port's serving path across the ranks and
writes what the rank saw to ``rank<r>.pkl``: quantized shards, logits,
greedy tokens, dispatch keys and the collectives of a decode step.
"""

from contextlib import contextmanager

import numpy as np
import torch

from test_torch_multirank_ranks import _inputs, dispatch_keys, f32_reduced

TOKENS_SHAPE = (2, 12)
#: the data axis's prefill: 4 rows, 2 a data rank
ROWS4_SHAPE = (4, 12)
DECODE_STEPS = 2
CACHE_SEQ = 16
#: the engine: 4 slots, so a data axis of 2 splits them; 3 do not split
ENGINE_SLOTS, ENGINE_SEQ, ENGINE_NEW = 4, 32, 5
#: the paged engine's geometry
PAGED = dict(page_size=8, max_pages=32, max_active=4, max_seq=64, eos=-1)
#: (the slots' positions, the cache length) of the recorded decode step
RECORD_POS, RECORD_SEQ = (3, 5, 4, 7), 16
#: the MoE layer's input (B, S) and capacity factor: enough tokens that
#: capacity drops assignments, so their positions matter
MOE_ROWS, MOE_SEQ, MOE_CAPACITY = 4, 40, 0.5
RUNGS = {"int8": (8, None), "int8-dynamic": (8, 8), "int4": (4, None)}
MOE_IMPLS = ("global", "hinted", "sharded")


def _plan(model_n):
    from repro_torch.dist.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_host_mesh

    return ShardingPlan(make_host_mesh(model=model_n))


def _granite(inputs, plan, arch="granite-8b"):
    """granite-8b (or ``arch``) reduced in f32 and this rank's shard of
    ``repro``'s parameters."""
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models import build_model
    from repro_torch.models.lm import params_from_jax

    model = build_model(f32_reduced(arch))
    full = params_from_jax(inputs[arch], device="cpu")
    return model, shard_tree(full, plan, plan.mesh.coords, model.param_specs())


def _quant_parts(tree, prefix=""):
    """path -> (values, scales) of every quantized leaf, as numpy."""
    from repro_torch.core.quant import is_quantized

    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_quant_parts(leaf, f"{prefix}{key}/"))
        elif is_quantized(leaf):
            out[prefix + key] = (leaf.values.numpy(), leaf.scales.numpy())
    return out


@contextmanager
def local_row_amax():
    """The planted fault: every dynamic row scale taken over this rank's
    part of the row only (the MAX all-reduce skipped)."""
    from repro_torch.core import gemm

    real = gemm.quantize_activations
    gemm.quantize_activations = lambda x, axis=None: real(x)
    try:
        yield
    finally:
        gemm.quantize_activations = real


def _chain(model, params, tokens):
    """Prefill logits of ``tokens`` and a greedy decode chain's."""
    logits, cache = model.prefill(params, tokens, max_seq=CACHE_SEQ)
    chain = [logits.numpy()]
    pos = torch.full((tokens.shape[0],), tokens.shape[1])
    for _ in range(DECODE_STEPS):
        nxt = logits[:, -1].argmax(-1)[:, None]
        logits, cache = model.decode_step(params, cache, nxt, pos)
        chain.append(logits.numpy())
        pos = pos + 1
    return chain


def _record_step(model, params):
    """The collectives of one decode step at ``RECORD_POS``."""
    from repro_torch.dist.collectives import record

    cache = model.init_cache(len(RECORD_POS), RECORD_SEQ, device="cpu")
    tokens = torch.arange(1, len(RECORD_POS) + 1)[:, None]
    with record() as stats:
        model.decode_step(params, cache, tokens, torch.as_tensor(RECORD_POS))
    return stats.summary()


def quantized_serving(plan, inputs, chain_rungs=tuple(RUNGS)) -> dict:
    """granite-8b reduced quantized on each rung under ``plan``: this
    rank's codes and scales, the prefill and decode chain's logits (the
    int8-dynamic one also with the planted local row amax), and a decode
    step's collectives."""
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import use_plan

    tokens = torch.as_tensor(inputs["tokens"]).long()
    out = {}
    with use_plan(plan), torch.no_grad(), gemm_context(device="cpu"):
        model, base = _granite(inputs, plan)
        out["float_record"] = _record_step(model, base)
        for rung in RUNGS:
            bits, act_bits = RUNGS[rung]
            params, n, _ = model.quantize_weights(base, bits=bits, act_bits=act_bits)
            got = dict(parts=_quant_parts(params), n=n, record=_record_step(model, params))
            if rung in chain_rungs:
                got["chain"] = _chain(model, params, tokens)
                if rung == "int8-dynamic":
                    with local_row_amax():
                        got["chain_local_amax"] = _chain(model, params, tokens)
            out[rung] = got
    return out


def moe_layer(plan, inputs) -> dict:
    """olmoe-1b-7b reduced's MoE layer on ``global``, ``hinted`` and
    ``sharded``, on float and int8 experts: this rank's rows of the output,
    the aux loss and each grouped dispatch's G."""
    from repro_torch.core.gemm import gemm_context
    from repro_torch.core.quant import quantize_lm_params
    from repro_torch.dist.sharding import local_rows, shard_tree, use_plan
    from repro_torch.models import layers

    p_np, x_np = inputs["moe"]
    out = {"coords": dict(plan.mesh.coords)}
    for impl in MOE_IMPLS:
        cfg = f32_reduced("olmoe-1b-7b", moe_impl=impl, capacity_factor=MOE_CAPACITY)
        specs = layers.moe_specs(cfg)
        with use_plan(plan), torch.no_grad():
            p = shard_tree({k: torch.from_numpy(v) for k, v in p_np.items()}, plan,
                           plan.mesh.coords, specs)
            x = local_rows({"x": torch.from_numpy(x_np)})["x"]
            for kind in ("float", "int8"):
                w = p if kind == "float" else quantize_lm_params(p, specs=specs, plan=plan)[0]
                with gemm_context(device="cpu") as ctx:
                    y, aux = layers.moe_apply(w, x, cfg, div={})
                out[impl, kind] = dict(y=y.numpy(), aux=float(aux),
                                       groups=sorted({e.op.g_local for e in ctx.log
                                                      if e.op.kind == "grouped"}))
    return out


def engine_tokens(plan, inputs, arch="granite-8b", slots=ENGINE_SLOTS) -> dict:
    """The slot engine's greedy tokens over ``inputs["prompts"]``, and the
    slots whose cache rows this rank holds."""
    from repro_torch.dist.sharding import shard_tree, use_plan
    from repro_torch.models import build_model
    from repro_torch.models.lm import params_from_jax
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    model = build_model(f32_reduced(arch))
    with use_plan(plan), torch.no_grad():
        params = shard_tree(params_from_jax(inputs[arch], device="cpu"), plan,
                            plan.mesh.coords, model.param_specs())
        engine = ServeEngine(model, params, ServeConfig(n_slots=slots, max_seq=ENGINE_SEQ,
                                                        eos=-1), device="cpu")
        for p in inputs["prompts"]:
            engine.submit(p, max_new_tokens=ENGINE_NEW)
        tokens = {r.uid: r.out_tokens for r in engine.run()}
    own = engine.own_slots
    return dict(tokens=tokens, own=None if own is None else (own.start, own.stop),
                cache_rows=int(engine.cache["attn"]["k"].shape[1]))


def data_axis(plan, inputs) -> dict:
    """granite-8b reduced on a plan with a data axis: a 4-row prefill and
    decode chain (rows split), the decode keys and logits of a 4-row step,
    the engine's tokens at 4 slots (split) and, on (2, 1), at 3 (whole
    rows), a decode step's collectives."""
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import use_plan

    out = {}
    tokens = torch.as_tensor(inputs["decode_tokens"]).long()
    with use_plan(plan), torch.no_grad():
        model, params = _granite(inputs, plan)
        cache = model.init_cache(tokens.shape[0], RECORD_SEQ, device="cpu")
        with gemm_context(device="cpu") as ctx:
            logits, _ = model.decode_step(params, cache, tokens, torch.as_tensor(RECORD_POS))
        out["decode_keys"] = dispatch_keys(ctx.log)
        out["decode_logits"] = logits.numpy()
        out["record"] = _record_step(model, params)
        with gemm_context(device="cpu"):
            out["chain"] = _chain(model, params, torch.as_tensor(inputs["rows4"]).long())
        # olmoe's MoE layers exchange their routing counts over data
        out["olmoe_record"] = _record_step(*_granite(inputs, plan, "olmoe-1b-7b"))
    out["engine"] = engine_tokens(plan, inputs)
    if plan.mesh.shape["model"] == 1:
        out["engine_whole"] = engine_tokens(plan, inputs, slots=3)
    out["olmoe_engine"] = engine_tokens(plan, inputs, arch="olmoe-1b-7b")
    return out


def paged(plan, inputs) -> dict:
    """The paged engine's greedy tokens and pool metrics on ``plan``, and
    its pool's kv heads."""
    from repro_torch.dist.sharding import use_plan
    from repro_torch.serve.scheduler import PagedServeConfig, PagedServeEngine

    with use_plan(plan), torch.no_grad():
        model, params = _granite(inputs, plan)
        engine = PagedServeEngine(model, params, PagedServeConfig(**PAGED), device="cpu")
        for p in inputs["prompts"]:
            engine.submit(p, max_new_tokens=ENGINE_NEW)
        done = {r.uid: r.out_tokens for r in engine.run()}
    return dict(tokens=done, metrics=engine.metrics(),
                kv_heads=int(engine.kv.pool["attn"]["k"].shape[-2]))


def program_two(rank, world, workdir) -> dict:
    """(1, 2): the quantized rungs, the MoE layer, the paged engine and
    olmoe's engine on its default dispatch; (2, 1): the data axis."""
    inputs = _inputs(workdir)
    one_two, two_one = _plan(2), _plan(1)
    return {"quant": quantized_serving(one_two, inputs), "moe": moe_layer(one_two, inputs),
            "paged": paged(one_two, inputs),
            "olmoe_engine": engine_tokens(one_two, inputs, arch="olmoe-1b-7b"),
            "data": data_axis(two_one, inputs)}


def program_four(rank, world, workdir) -> dict:
    """(2, 2): the quantized rungs' codes and the int8-dynamic logits, the
    MoE layer, the data axis."""
    inputs = _inputs(workdir)
    plan = _plan(2)
    return {"quant": quantized_serving(plan, inputs, chain_rungs=("int8-dynamic",)), "moe": moe_layer(plan, inputs), "data": data_axis(plan, inputs)}


def f32_olmoe_moe_inputs(seed=21):
    """The MoE layer's float parameters and input (numpy)."""
    from repro_torch.models import layers

    cfg = f32_reduced("olmoe-1b-7b")
    r = np.random.default_rng(seed)
    p = {name: (r.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for name, s in layers.moe_specs(cfg).items()}
    return p, r.normal(size=(MOE_ROWS, MOE_SEQ, cfg.d_model)).astype(np.float32)

