"""The rank side of ``tests/test_torch_multirank_families.py``: what each
``gloo`` rank runs. It holds no tests and imports neither jax nor the JAX
package (``torch.multiprocessing`` imports it in every rank it starts).

Each program reads ``inputs.pkl`` (``repro``'s numpy parameter trees, the
prompts and each family's extra input), serves the SSM, hybrid, VLM and
encoder-decoder families across the ranks and writes what the rank saw to
``rank<r>.pkl``: logits, the prefill's ``ssm`` cache shards, greedy
tokens, dispatch keys and the collectives of a decode step.
"""

import numpy as np
import torch

from test_torch_multirank_ranks import _inputs, _plan, dispatch_keys, f32_reduced

FAMILIES = ("mamba2-1.3b", "zamba2-1.2b", "llava-next-34b", "whisper-large-v3")
#: the (1, 4) cases whose heads do not divide the model axis, by name: (arch,
#: config overrides). llava and whisper: 6 query heads, so the plan splits
#: the query columns inside a head (24 a rank); mamba2: 2 SSM heads of 64,
#: so ``h`` and ``w_in`` (290 columns) stay whole and ``w_out``'s rows split
#: inside a head
UNEVEN = {"llava-next-34b/6-heads": ("llava-next-34b", {"n_heads": 6}),
          "whisper-large-v3/6-heads": ("whisper-large-v3", {"n_heads": 6, "n_kv_heads": 6}),
          "mamba2-1.3b/2-heads": ("mamba2-1.3b", {"ssm_head_dim": 64})}
#: the prefill batch (rows, prompt length), its cache length and the greedy
#: decode steps after it; a VLM's first ``n_patches`` positions are its patches
ROWS, PROMPT, CACHE_SEQ, DECODE_STEPS = 2, 9, 16, 2
#: (the slots' positions, the cache length) of the recorded decode step
RECORD_POS, RECORD_SEQ = (3, 5), 16
ENGINE_SLOTS, ENGINE_SEQ, ENGINE_NEW = 2, 40, 5
ENGINE_FAMILIES = FAMILIES[:2]


def arch_of(case):
    """The config a case is built from: a family's arch, or an ``UNEVEN``
    case's."""
    return UNEVEN[case][0] if case in UNEVEN else case


def config_of(case):
    """The reduced f32 config of a family or an ``UNEVEN`` case."""
    return f32_reduced(arch_of(case), **UNEVEN.get(case, (None, {}))[1])


def prefill(model, params, tokens, extra):
    """``model.prefill`` of ``tokens`` with the family's extra input (a
    VLM's patch embeddings, an encoder-decoder's frames)."""
    family = model.cfg.family
    if family == "encdec":
        return model.prefill(params, extra, tokens, max_seq=CACHE_SEQ)
    kw = {"patch_embeds": extra} if family == "vlm" else {}
    return model.prefill(params, tokens, max_seq=CACHE_SEQ, **kw)


def _sharded_model(arch, inputs, plan):
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models import build_model
    from repro_torch.models.lm import params_from_jax

    model = build_model(config_of(arch))
    full = params_from_jax(inputs[arch]["params"], device="cpu")
    return model, shard_tree(full, plan, plan.mesh.coords, model.param_specs())


def serve_family(plan, inputs, arch) -> dict:
    """``arch`` reduced in f32 under ``plan``: the prefill logits and a
    greedy decode chain's, the prefill's ``ssm`` cache shards, each phase's
    dispatch keys, and one decode step's collectives."""
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import use_plan

    tokens = torch.as_tensor(inputs[arch]["tokens"]).long()
    extra = inputs[arch]["extra"]
    extra = None if extra is None else torch.from_numpy(extra)
    out = {}
    with use_plan(plan), torch.no_grad():
        model, params = _sharded_model(arch, inputs, plan)
        with gemm_context(device="cpu") as ctx:
            logits, cache = prefill(model, params, tokens, extra)
        out["prefill_keys"] = dispatch_keys(ctx.log)
        # copies: the decode steps write the cache in place
        out["ssm"] = {k: v.clone().numpy() for k, v in cache.get("ssm", {}).items()}
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
        step = model.init_cache(len(RECORD_POS), RECORD_SEQ, device="cpu")
        with record() as stats:
            model.decode_step(params, step, torch.arange(1, len(RECORD_POS) + 1)[:, None],
                              torch.as_tensor(RECORD_POS))
        out["record"] = stats.summary()
    return out


def engine_tokens(plan, inputs, arch) -> dict:
    """The slot engine's greedy tokens over ``inputs["prompts"]`` (more
    requests than slots, so slots are reused) and its ``ssm`` cache's
    local shapes."""
    from repro_torch.dist.sharding import use_plan
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    with use_plan(plan), torch.no_grad():
        model, params = _sharded_model(arch, inputs, plan)
        engine = ServeEngine(model, params, ServeConfig(n_slots=ENGINE_SLOTS, max_seq=ENGINE_SEQ,
                                                        eos=-1), device="cpu")
        for p in inputs["prompts"]:
            engine.submit(p, max_new_tokens=ENGINE_NEW)
        tokens = {r.uid: r.out_tokens for r in engine.run()}
    return dict(tokens=tokens, ssm_shapes={k: tuple(v.shape)
                                           for k, v in engine.cache["ssm"].items()})


def program_two(rank, world, workdir) -> dict:
    """(1, 2): every family served, mamba2's and zamba2's engines; (2, 1):
    mamba2 on the data axis."""
    inputs = _inputs(workdir)
    one_two = _plan(2)
    out = {"1x2": {arch: serve_family(one_two, inputs, arch) for arch in FAMILIES},
           "engine": {arch: engine_tokens(one_two, inputs, arch) for arch in ENGINE_FAMILIES}}
    out["2x1"] = {"mamba2-1.3b": serve_family(_plan(1), inputs, "mamba2-1.3b")}
    return out


def program_four(rank, world, workdir) -> dict:
    """(2, 2): mamba2 on both axes; (1, 4): the ``UNEVEN`` cases."""
    inputs = _inputs(workdir)
    return {"2x2": {"mamba2-1.3b": serve_family(_plan(2), inputs, "mamba2-1.3b")},
            "1x4": {case: serve_family(_plan(4), inputs, case) for case in UNEVEN}}


def family_inputs(arch, seed=3):
    """The (ROWS, PROMPT) tokens and the family's extra input (numpy): a
    VLM's patch embeddings (ROWS, P, D), an encoder-decoder's frames
    (ROWS, F, D), else None."""
    cfg = config_of(arch)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (ROWS, PROMPT)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = (rng.normal(size=(ROWS, cfg.n_patches, cfg.d_model)) * 0.5).astype(np.float32)
    elif cfg.family == "encdec":
        extra = rng.normal(size=(ROWS, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return tokens, extra
