"""The rank side of ``tests/test_torch_multirank.py``: what each ``gloo``
rank runs. It holds no tests. ``torch.multiprocessing`` imports this module
in every rank it starts, which keeps jax and the JAX package out of them;
the test module computes ``repro``'s references in its own process.

Each program reads the inputs the test wrote (``inputs.pkl``: numpy
parameter trees and batches), runs the port across the ranks, and writes
what the rank saw to ``rank<r>.pkl``.
"""

import dataclasses
import datetime
import math
import os
import pickle
import shutil
import time

import torch

GROUP_TIMEOUT_S = 60
GRANITE_TOKENS_SHAPE = (2, 12)
DECODE_STEPS = 3
CACHE_SEQ = 16
ENGINE_SLOTS, ENGINE_SEQ, ENGINE_NEW = 2, 32, 6
#: (the slots' positions, the cache length) of the decode step whose
#: collectives are held against the dry run's
RECORD_POS, RECORD_SEQ = (3, 5), 16
TRAIN_BATCH, TRAIN_SEQ = 4, 16
TRAIN_STEPS = 3


def run_ranks(program, world: int, workdir, timeout: float = 120.0) -> dict:
    """Start ``world`` ranks running ``program(rank, world, workdir)`` over a
    file rendezvous in ``workdir``, wait at most ``timeout`` seconds (then
    kill them and raise), and return each rank's ``rank<r>.pkl``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_entry, args=(program, world, str(workdir)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {program.__name__} ran past {timeout}s")
    out = {}
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)
    return out


def _entry(rank, program, world, workdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = program(rank, world, workdir)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _inputs(workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def f32_reduced(arch, **kw):
    from repro_torch.configs import get_reduced

    return dataclasses.replace(get_reduced(arch), dtype="float32", **kw)


def dispatch_keys(log):
    return sorted({f"{e.tag}:{e.local_mnk}" for e in log})


def _plan(model_n):
    from repro_torch.dist.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_host_mesh

    return ShardingPlan(make_host_mesh(model=model_n))


def serve_granite(plan, inputs) -> dict:
    """granite-8b reduced in f32 under ``plan``: the prefill logits of a
    (2, 12) batch and a greedy decode chain, each phase's dispatch keys,
    the engine's greedy tokens, and one decode step's collectives."""
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import shard_tree, use_plan
    from repro_torch.models import build_model
    from repro_torch.models.lm import params_from_jax
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    model = build_model(f32_reduced("granite-8b"))
    full = params_from_jax(inputs["granite"], device="cpu")
    tokens = torch.as_tensor(inputs["granite_tokens"]).long()
    out = {}
    with use_plan(plan), torch.no_grad():
        params = shard_tree(full, plan, plan.mesh.coords, model.param_specs())
        with gemm_context(device="cpu") as ctx:
            logits, cache = model.prefill(params, tokens, max_seq=CACHE_SEQ)
        out["prefill_keys"] = dispatch_keys(ctx.log)
        chain = [logits.numpy()]
        pos = torch.full((tokens.shape[0],), tokens.shape[1])
        with gemm_context(device="cpu") as ctx:
            for _ in range(DECODE_STEPS):
                nxt = logits[:, -1].argmax(-1)[:, None]
                logits, cache = model.decode_step(params, cache, nxt, pos)
                chain.append(logits.numpy())
                pos = pos + 1
        out["decode_keys"] = dispatch_keys(ctx.log)
        out["chain"] = chain
        engine = ServeEngine(model, params, ServeConfig(n_slots=ENGINE_SLOTS,
                                                        max_seq=ENGINE_SEQ, eos=-1),
                             device="cpu")
        for p in inputs["prompts"]:
            engine.submit(p, max_new_tokens=ENGINE_NEW)
        out["tokens"] = {r.uid: r.out_tokens for r in engine.run()}
        cache = model.init_cache(len(RECORD_POS), RECORD_SEQ, device="cpu")
        with record() as stats:
            model.decode_step(params, cache, tokens[:, :1], torch.as_tensor(RECORD_POS))
        out["decode_record"] = stats.summary()
        out["kv_cache_heads"] = int(cache["attn"]["k"].shape[-2])
    return out


def moe_layer(plan, inputs) -> dict:
    """olmoe-1b-7b reduced's MoE layer on ``shard_map`` and
    ``shard_map_bf16``: this rank's rows of the output and the aux loss."""
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import local_rows, shard_tree, use_plan
    from repro_torch.models import layers

    out = {}
    p_np, x_np = inputs["moe"]
    for impl in ("shard_map", "shard_map_bf16"):
        cfg = f32_reduced("olmoe-1b-7b", moe_impl=impl, capacity_factor=0.5)
        full = {k: torch.from_numpy(v) for k, v in p_np.items()}
        with use_plan(plan), gemm_context(device="cpu") as ctx, torch.no_grad():
            p = shard_tree(full, plan, plan.mesh.coords, layers.moe_specs(cfg))
            x = local_rows({"x": torch.from_numpy(x_np)})["x"]
            y, aux = layers.moe_apply(p, x, cfg, div={})
        out[impl] = dict(y=y.numpy(), aux=float(aux), groups=[e.op.g_local for e in ctx.log])
    out["coords"] = dict(plan.mesh.coords)
    return out


def program_two(rank, world, workdir) -> dict:
    """(1, 2): granite serving and the MoE layer."""
    inputs = _inputs(workdir)
    plan = _plan(2)
    return {"serve": serve_granite(plan, inputs), "moe": moe_layer(plan, inputs)}


def _granite_trainer(inputs, steps, ckpt_dir):
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig

    cfg = f32_reduced("granite-8b")
    model = build_model(cfg)
    opt = make_optimizer("adamw", warmup_cosine(3e-3, 2, 2 * TRAIN_STEPS))
    data = SyntheticLMData(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=1)
    return model, opt, Trainer(model, opt, data, TrainerConfig(
        total_steps=steps, log_every=100, ckpt_dir=ckpt_dir, ckpt_every=100))


def _first_grads(plan, inputs):
    """The first step's gradient leaves, summed and gathered whole, and their
    global norm as the train step sums it across the ranks."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.collectives import global_norm, sync_grads
    from repro_torch.dist.sharding import gather_tree, local_rows, shard_tree, use_plan
    from repro_torch.models.lm import params_from_jax
    from repro_torch.train.trainer import take_grads, to_device_batch
    from repro_torch.utils.trees import tree_items

    model, _, _ = _granite_trainer(inputs, 1, None)
    data = SyntheticLMData(model.cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=1)
    with use_plan(plan):
        params = shard_tree(params_from_jax(inputs["granite"], device="cpu"), plan,
                            plan.mesh.coords, model.param_specs())
        for _, leaf in tree_items(params):
            leaf.requires_grad_(True)
        loss, _ = model.loss_fn(params, local_rows(to_device_batch(data.batch_at(0), "cpu")))
        loss.backward()
        grads = sync_grads(take_grads(params), model.param_specs(), plan)
        norm = global_norm(grads, model.param_specs(), plan)
        return _np_tree(gather_tree(grads, plan, model.param_specs())), float(norm)


def elastic(rank, inputs, workdir) -> dict:
    """granite-8b reduced: 3 steps on (4, 1) checkpointed, resumed for 3
    steps on (2, 2) and, from the same checkpoint, on (1, 4); each mesh's
    first-step gradients gathered whole; a train step's collectives on
    (2, 2); and a shard/gather round trip of the parameters on (2, 2)."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import gather_tree, local_rows, shard_tree, use_plan
    from repro_torch.models.lm import params_from_jax
    from repro_torch.train import init_train_state
    from repro_torch.train.trainer import make_train_step, to_device_batch

    out = {"grads": {}, "norms": {}, "history": {}}
    ckpt = os.path.join(workdir, "ckpt_41")
    for shape in ((4, 1), (2, 2), (1, 4)):
        plan = _plan(shape[1])
        out["grads"][shape], out["norms"][shape] = _first_grads(plan, inputs)
        model, opt, trainer = _granite_trainer(
            inputs, TRAIN_STEPS if shape == (4, 1) else 2 * TRAIN_STEPS,
            ckpt if shape != (1, 4) else ckpt + "_copy")
        with use_plan(plan):
            params = shard_tree(params_from_jax(inputs["granite"], device="cpu"), plan,
                                plan.mesh.coords, model.param_specs())
            state = trainer.fit(init_train_state(model, opt, params))
        out["history"][shape] = list(trainer.history)
        if shape == (4, 1):
            if rank == 0:  # the (1, 4) run resumes from the step-3 checkpoint too
                shutil.copytree(ckpt, ckpt + "_copy")
            dist.barrier()
        if shape == (2, 2):
            specs = model.param_specs()
            full = params_from_jax(inputs["granite"], device="cpu")
            with use_plan(plan):
                local = shard_tree(full, plan, plan.mesh.coords, specs)
                back = gather_tree(local, plan, specs)
                step = make_train_step(model, opt)
                train = init_train_state(model, opt, local)
                batch = local_rows(to_device_batch(trainer.data.batch_at(0), "cpu"))
                with record() as stats:
                    step(train, batch)
            out["round_trip"] = _trees_equal(back, full)
            out["train_record"] = stats.summary()
        del state
    return out


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def exchange_input(rank) -> torch.Tensor:
    """A (4, 6) input that differs on every rank, exact in f32."""
    return torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1) + rank


def exchange_weight(rank, shape) -> torch.Tensor:
    """The weights of a rank's loss over an exchange's output, exact in f32."""
    return torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape) * 0.5 + 10 * rank


def exchanges(plan, rank) -> dict:
    """The public reduce-scatter (over ``model``, along dim 1) and
    all-to-all (over ``data``, split dim 0, concatenated along dim 1) of
    :func:`exchange_input`: each one's output and the gradient its backward
    gives the input under the loss ``sum(out * exchange_weight)``, and what
    the two recorded."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import use_plan

    out = {}
    with use_plan(plan), collectives.record() as stats:
        for name, fn in (("reduce_scatter", lambda x: collectives.reduce_scatter(x, "model", 1)),
                         ("all_to_all", lambda x: collectives.all_to_all(x, "data", 0, 1))):
            x = exchange_input(rank).requires_grad_(True)
            y = fn(x)
            (y * exchange_weight(rank, tuple(y.shape))).sum().backward()
            out[name] = (y.detach().numpy(), x.grad.numpy())
    out["record"] = stats.summary()
    return out


def program_four(rank, world, workdir) -> dict:
    """(1, 4) granite serving, the MoE layer on (2, 2), elastic training,
    the reduce-scatter and the all-to-all on (2, 2)."""
    inputs = _inputs(workdir)
    return {"serve": serve_granite(_plan(4), inputs), "moe": moe_layer(_plan(2), inputs),
            "train": elastic(rank, inputs, workdir), "exchanges": exchanges(_plan(2), rank)}
