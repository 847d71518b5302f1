"""The rank side of ``tests/test_torch_multirank_seq.py``: what each
``gloo`` rank runs. It holds no tests and imports neither jax nor the JAX
package (``torch.multiprocessing`` imports it in every rank it starts).

Each program reads ``inputs.pkl`` (``repro``'s numpy parameter trees, the
prompts), runs ``repro``'s production sharding rules across the ranks and
writes what the rank saw to ``rank<r>.pkl``: a sequence-parallel train
step's loss and gradients, Adafactor's parameters and moments, decode
logits and cache shards under a ``kv_seq`` split, greedy tokens, and the
collectives of a step.
"""

import numpy as np
import torch

from test_torch_multirank_ranks import _inputs, _np_tree, f32_reduced

#: the reduced configs a sequence-parallel train step runs
TRAIN_ARCHS = ("granite-8b", "olmoe-1b-7b", "mamba2-1.3b", "whisper-large-v3")
#: a case on (1, 4) whose query columns split over model while its one kv head
#: (18 columns) does not: every rank reads its query heads' kv heads of whole kv
#: weights, so the weights' gradients, and not the kv's, are summed over model
WHOLE_KV = {"granite-8b/whole-kv": ("granite-8b", {"n_kv_heads": 1, "d_head": 18})}
TRAIN_BATCH, TRAIN_SEQ = 4, 16
ADAFACTOR_STEPS = 3
#: the decode cases: name -> (arch, config overrides, shape whose rules
#: apply, rows, prompt length); granite's 2 kv heads do not divide a model
#: axis of 4, so its decode rule splits the cache's positions over model;
#: zamba2's batch of one leaves long_500k's kv_seq on the data axis
DECODE = {"granite-8b": ("granite-8b", {}, "decode_32k", 2, 10),
          "granite-8b/int8": ("granite-8b", {"kv_cache_dtype": "int8"}, "decode_32k", 2, 10),
          "zamba2-1.2b": ("zamba2-1.2b", {}, "long_500k", 1, 7)}
CACHE_SEQ, DECODE_STEPS = 16, 3
ENGINE_SEQ, ENGINE_NEW = 32, 5
ENGINE_SLOTS = {"granite-8b": 2, "zamba2-1.2b": 1}
#: (the slots' positions, the cache length) of the recorded decode steps
RECORD_POS, RECORD_SEQ = {"granite-8b": (3, 5), "zamba2-1.2b": (9,)}, 16


def arch_and_overrides(case):
    """(the arch a case is built from, its config overrides)."""
    if case in DECODE:
        return DECODE[case][:2]
    return WHOLE_KV.get(case, (case, {}))


def config_of(case):
    arch, over = arch_and_overrides(case)
    return f32_reduced(arch, **over)


def cell_rules(arch_or_case, shape_name, mesh_shape):
    """``repro``'s ``rules_for_cell`` for the reduced config on a
    (data, model) mesh (the port's copy of it)."""
    from repro_torch.launch.dryrun import rules_for_cell
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import SHAPES_BY_NAME

    return rules_for_cell(config_of(arch_or_case), SHAPES_BY_NAME[shape_name],
                          MeshShape(tuple(mesh_shape), ("data", "model")))


def _plan(model_n, rules):
    from repro_torch.dist.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_host_mesh

    return ShardingPlan(make_host_mesh(model=model_n), rules)


def _model(case, inputs, plan):
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models import build_model
    from repro_torch.models.lm import params_from_jax

    model = build_model(config_of(case))
    # the kv cache's dtype changes no parameter: a decode case reads its arch's
    full = params_from_jax(inputs[case if case in inputs else arch_and_overrides(case)[0]],
                           device="cpu")
    return model, shard_tree(full, plan, plan.mesh.coords, model.param_specs())


def train_batch(arch, step=0):
    """The train batch (numpy) of ``SyntheticLMData`` at ``step`` (``arch``: an arch or a
    case)."""
    from repro_torch.data import SyntheticLMData

    return SyntheticLMData(config_of(arch), batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                           seed=1).batch_at(step)


def sp_grads(plan, inputs, arch) -> dict:
    """One sequence-parallel step's global loss and its gradient leaves,
    synchronised as the train step does and gathered whole."""
    from repro_torch.dist.collectives import all_reduce_axes, sync_grads
    from repro_torch.dist.sharding import batch_axes, gather_tree, local_rows, use_plan
    from repro_torch.train.trainer import take_grads, to_device_batch
    from repro_torch.utils.trees import tree_items

    with use_plan(plan):
        model, params = _model(arch, inputs, plan)
        specs = model.param_specs()
        for _, leaf in tree_items(params):
            leaf.requires_grad_(True)
        batch = local_rows(to_device_batch(train_batch(arch), "cpu"))
        loss, _ = model.loss_fn(params, batch)
        loss.backward()
        grads = sync_grads(take_grads(params), specs, plan, model.seq_parallel_leaves(batch))
        loss = all_reduce_axes(loss.detach(), batch_axes(plan))
        return {"loss": float(loss), "grads": _np_tree(gather_tree(grads, plan, specs)),
                "seq_leaves": model.seq_parallel_leaves(batch)}


def train_record(plan, inputs, arch) -> dict:
    """The collectives of one train step (AdamW, as the dry run traces it)."""
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import local_rows, use_plan
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.train import init_train_state
    from repro_torch.train.trainer import make_train_step, to_device_batch

    with use_plan(plan):
        model, params = _model(arch, inputs, plan)
        opt = make_optimizer("adamw", constant(1e-4))
        state = init_train_state(model, opt, params)
        batch = local_rows(to_device_batch(train_batch(arch), "cpu"))
        with record() as stats:
            make_train_step(model, opt)(state, batch)
    return stats.summary()


def adafactor(plan, inputs, arch="granite-8b") -> dict:
    """``ADAFACTOR_STEPS`` train steps with Adafactor on the stream: the
    losses, then the parameters and the optimizer state gathered whole."""
    from repro_torch.dist.sharding import gather_tree, local_rows, use_plan
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import init_train_state
    from repro_torch.train.trainer import make_train_step, to_device_batch

    with use_plan(plan):
        model, params = _model(arch, inputs, plan)
        opt = make_optimizer("adafactor", warmup_cosine(3e-3, 1, 2 * ADAFACTOR_STEPS))
        state = init_train_state(model, opt, params)
        step = make_train_step(model, opt)
        losses = []
        for i in range(ADAFACTOR_STEPS):
            batch = local_rows(to_device_batch(train_batch(arch, i), "cpu"))
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        specs = model.param_specs()
        opt_state = {k: v for k, v in state["opt"].items() if k != "count"}
        return {"losses": losses,
                "params": _np_tree(gather_tree(state["params"], plan, specs)),
                "opt": _np_tree(gather_tree(opt_state, plan, specs))}


def decode_tokens(case):
    """The (rows, prompt) tokens of a decode case."""
    cfg = config_of(case)
    rows, prompt = DECODE[case][3:]
    return np.random.default_rng(5).integers(1, cfg.vocab_size, (rows, prompt)).astype(np.int32)


def kv_decode(plan, inputs, case) -> dict:
    """A case's prefill logits and greedy decode chain under ``plan``, the
    prefill's cache shards, and one decode step's collectives."""
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import use_plan

    arch = DECODE[case][0]
    tokens = torch.as_tensor(decode_tokens(case)).long()
    out = {}
    with use_plan(plan), torch.no_grad():
        model, params = _model(case, inputs, plan)
        logits, cache = model.prefill(params, tokens, max_seq=CACHE_SEQ)
        out["cache"] = {group: {k: v.clone().numpy() for k, v in leaves.items()}
                        for group, leaves in cache.items()}
        chain = [logits.numpy()]
        pos = torch.full((tokens.shape[0],), tokens.shape[1])
        for _ in range(DECODE_STEPS):
            nxt = logits[:, -1].argmax(-1)[:, None]
            logits, cache = model.decode_step(params, cache, nxt, pos)
            chain.append(logits.numpy())
            pos = pos + 1
        out["chain"] = chain
        if case == arch:
            where = RECORD_POS[arch]
            step = model.init_cache(len(where), RECORD_SEQ, device="cpu")
            with record() as stats:
                model.decode_step(params, step, torch.arange(1, len(where) + 1)[:, None],
                                  torch.as_tensor(where))
            out["record"] = stats.summary()
    return out


def engine_tokens(plan, inputs, arch) -> dict:
    """The slot engine's greedy tokens over ``inputs["prompts"]`` (more
    requests than slots) and its cache's local shapes."""
    from repro_torch.dist.sharding import use_plan
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    with use_plan(plan), torch.no_grad():
        model, params = _model(arch, inputs, plan)
        engine = ServeEngine(model, params, ServeConfig(n_slots=ENGINE_SLOTS[arch],
                                                        max_seq=ENGINE_SEQ, eos=-1),
                             device="cpu")
        for p in inputs["prompts"]:
            engine.submit(p, max_new_tokens=ENGINE_NEW)
        tokens = {r.uid: r.out_tokens for r in engine.run()}
    return dict(tokens=tokens, attn_shape=tuple(engine.cache["attn"]["k"].shape))


def program_two(rank, world, workdir) -> dict:
    """(1, 2): the train steps under ``seq = "model"``, a train step's
    collectives, Adafactor; (2, 1): Adafactor with FSDP over data, zamba2's
    long_500k decode and engine."""
    inputs = _inputs(workdir)
    sp = _plan(2, cell_rules("granite-8b", "train_4k", (1, 2)))
    out = {"1x2": {"grads": {arch: sp_grads(sp, inputs, arch) for arch in TRAIN_ARCHS},
                   "train_record": train_record(sp, inputs, "granite-8b"),
                   "adafactor": adafactor(sp, inputs)}}
    data = _plan(1, cell_rules("granite-8b", "train_4k", (2, 1)))
    long = _plan(1, cell_rules("zamba2-1.2b", "long_500k", (2, 1)))
    out["2x1"] = {"adafactor": adafactor(data, inputs),
                  "decode": {"zamba2-1.2b": kv_decode(long, inputs, "zamba2-1.2b")},
                  "engine": {"zamba2-1.2b": engine_tokens(long, inputs, "zamba2-1.2b")}}
    return out


def program_four(rank, world, workdir) -> dict:
    """(2, 2): the train steps under ``seq = "model"``; (1, 4): granite's
    decode under its kv_seq rule (model and int8 KV caches) and its
    engine."""
    inputs = _inputs(workdir)
    sp = _plan(2, cell_rules("granite-8b", "train_4k", (2, 2)))
    kv = _plan(4, cell_rules("granite-8b", "decode_32k", (1, 4)))
    whole_kv = _plan(4, cell_rules("granite-8b", "train_4k", (1, 4)))
    return {"2x2": {"grads": {arch: sp_grads(sp, inputs, arch) for arch in TRAIN_ARCHS}},
            "1x4": {"decode": {case: kv_decode(kv, inputs, case)
                               for case in ("granite-8b", "granite-8b/int8")},
                    "engine": {"granite-8b": engine_tokens(kv, inputs, "granite-8b")},
                    "grads": {case: sp_grads(whole_kv, inputs, case) for case in WHOLE_KV}}}
