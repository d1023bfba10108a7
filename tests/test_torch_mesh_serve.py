"""Port parity: serving on a mesh of ranks (``tfm.prefill``, ``decode_step``,
``init_cache``, ``train.generate``, ``make_prefill_step`` /
``make_decode_step`` under ``sharding.use_mesh``) against the one-process
port, and the one-process port's serving against the JAX reference's.

One CPU gloo world of 8 ranks (``tests/test_torch_distributed.py:
run_world``) on a (2, 4) ``("data", "model")`` mesh serves every arch at
its smoke config (2 periods, f32): each rank keeps its blocks of the
weights the test process drew (``state_pspecs``) and its rows of 4 prompts,
prefills a cache of ``S + 4`` positions and decodes 3 tokens.  The
prefill's logits and every decode step's are held to the one-process
port's rows within 1e-5 relative (the largest difference over the largest
logit).  The cases cover a query-head group split between ranks (qwen3:
4 heads over tp 4, 2 KV heads), the MoE at the drop-free capacity 4.0 and
the window's ring (mixtral: a 72-token prompt in a 64-slot ring), MLA's
latent cache (deepseek), the whole-over-``model`` SSD and RG-LRU states
(mamba2, recurrentgemma), the frames and vision front ends (musicgen, the
vision model with its cross-attention gates opened).  Each rank's caches
are its blocks of the one-process caches (``tfm.cache_specs``: the GQA and
MLA positions split over ``model``, 1/8 of the bytes at (2, 4)), within
the same tolerance.  No sharded reference is compared (ROADMAP §C); the
one-process port is held to the JAX reference's ``prefill``/``decode_step``
(under ``jax.jit``) on llama in f32 instead.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import list_archs, smoke_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.sharding import Mesh, PartitionSpec, collectives  # noqa: E402
from repro_torch.train import generate  # noqa: E402

from test_torch_distributed import run_world  # noqa: E402

MESH = (2, 4)
B, NEW, EXTRA = 4, 3, 4  # prompts, decode steps, cache positions beyond the prompt
SEQ = {"mixtral-8x7b": 72}  # a ring of 64 slots that the prompt wraps
S_DEFAULT = 32
REL = 1e-5
RANK_BODY = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.sharding import PartitionSpec, collectives as col, use_mesh
from repro_torch.train import generate, make_decode_step, make_prefill_step, state_pspecs

mesh = make_mesh(%(mesh)r, ("data", "model"))
rows = lambda t: col.shard_block(t, PartitionSpec("data"), mesh)
for arch in %(archs)r:
    d = torch.load(f"{tmp}/../{arch}.pt", weights_only=False)
    cfg, S = d["cfg"], d["S"]
    params = tree_map(lambda t, s: col.shard_block(t, s, mesh), d["params"], state_pspecs(cfg, mesh).params)
    batch = {k: rows(v) for k, v in d["batch"].items()}
    img = rows(d["img"]) if d["img"] is not None else None
    prefill, decode = make_prefill_step(cfg, mesh), make_decode_step(cfg, mesh)
    col.reset_bytes()
    if arch == "qwen3-0.6b":  # through the step factory
        logits, cache = prefill(params, batch, S_cache=S + %(extra)d)
    else:
        with use_mesh(mesh):
            logits, cache = tfm.prefill(cfg, params, batch, S_cache=S + %(extra)d)
    out = [logits]
    for i in range(%(new)d):
        t = S + i
        tok = rows(d["next"][:, i]) if d["next"] is not None else None
        emb = rows(d["next_embeds"][:, i]) if d["next_embeds"] is not None else None
        logits, cache = decode(params, cache, tok, t, embeds=emb, img=img)
        out.append(logits)
    results[arch] = dict(logits=out, cache=[c.clone() for c in tree_leaves(cache)], bytes=dict(col.BYTES))
    if arch == "llama3.2-1b":
        with use_mesh(mesh):
            results["generate"] = generate(cfg, params, batch["tokens"], max_new=4)
        results["prefill_step"] = prefill(params, batch, S_cache=S + %(extra)d)[0]
"""


def _config(arch):
    cfg = smoke_config(arch)
    if cfg.moe is not None:  # drop-free: the capacity from a rank's tokens drops nothing either
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    return cfg


def _case(arch):
    """The weights (seed 0, the gates opened), the prompts and the decode
    inputs of an arch, as the ranks load them."""
    cfg = _config(arch)
    S = SEQ.get(arch, S_DEFAULT)
    params = tfm.init_params(cfg, 0, device="cpu")
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "cross_attn":  # zero at init adds nothing
            gate = params["pattern"][i]["mixer"]["gate"]
            params["pattern"][i]["mixer"]["gate"] = torch.linspace(0.3, 0.7, gate.numel()).reshape(gate.shape)
    rng = np.random.default_rng(7)
    img = None
    if cfg.frontend == "frames":
        full = torch.as_tensor(rng.standard_normal((B, S + NEW, cfg.d_model)).astype(np.float32))
        batch, nxt, nxt_e = {"embeds": full[:, :S]}, None, full[:, S:]
    else:
        full = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + NEW)).astype(np.int64))
        batch, nxt, nxt_e = {"tokens": full[:, :S]}, full[:, S:], None
    if cfg.frontend == "vision":
        img = torch.as_tensor(rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32))
        batch["image_embeds"] = img
    return dict(cfg=cfg, S=S, params=params, batch=batch, img=img, next=nxt, next_embeds=nxt_e)


def _one_process(case):
    cfg, S = case["cfg"], case["S"]
    logits, cache = tfm.prefill(cfg, case["params"], case["batch"], S_cache=S + EXTRA)
    out = [logits]
    for i in range(NEW):
        tok = case["next"][:, i] if case["next"] is not None else None
        emb = case["next_embeds"][:, i] if case["next_embeds"] is not None else None
        logits, cache = tfm.decode_step(cfg, case["params"], cache, tok, S + i, embeds=emb, img=case["img"])
        out.append(logits)
    return out, cache


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the ranks' results, the one-process results and cases by arch)."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    cases = {arch: _case(arch) for arch in list_archs()}
    for arch, case in cases.items():
        torch.save(case, tmp / f"{arch}.pt")
    ranks = run_world(tmp / "world8", 8, RANK_BODY % dict(mesh=MESH, archs=list_archs(), new=NEW, extra=EXTRA),
                      timeout=240.0)
    return ranks, {arch: _one_process(case) for arch, case in cases.items()}, cases


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("arch", list_archs())
def test_mesh_prefill_and_decode_match_the_one_process_port(served, arch):
    ranks, one, _ = served
    want, _ = one[arch]
    for r, rank in enumerate(ranks):
        d = Mesh(MESH, ("data", "model"), rank=r).coords["data"]
        rows = slice(d * B // MESH[0], (d + 1) * B // MESH[0])
        for i, (got, w) in enumerate(zip(rank[arch]["logits"], want)):
            assert got.shape == w[rows].shape
            assert _rel(got, w[rows]) <= REL, f"rank {r}, step {i}: {_rel(got, w[rows])}"


@pytest.mark.parametrize("arch", list_archs())
def test_each_rank_holds_its_block_of_the_caches(served, arch):
    """Every leaf of a rank's caches is its block (``tfm.cache_specs``) of
    the one-process caches after the same prefill and decode steps."""
    ranks, one, cases = served
    cfg, S = cases[arch]["cfg"], cases[arch]["S"]
    _, cache = one[arch]
    want = tree_leaves(cache)
    for r, rank in enumerate(ranks):
        mesh = Mesh(MESH, ("data", "model"), rank=r)
        specs = tree_leaves(tfm.cache_specs(cfg, B, S + EXTRA, mesh), is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert len(specs) == len(want) == len(rank[arch]["cache"])
        for got, w, spec in zip(rank[arch]["cache"], want, specs):
            block = w[collectives.block_slices(w.shape, spec, mesh)]
            assert got.shape == block.shape and got.dtype == block.dtype
            assert float((got - block).abs().max()) <= REL * max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-0.6b", "mixtral-8x7b", "deepseek-v2-236b"])
def test_the_position_split_caches_are_an_eighth(served, arch):
    """The GQA and MLA caches: each rank holds its rows (1/2) and its
    positions (1/4) — 1/8 of the one-process bytes."""
    ranks, one, _ = served
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(one[arch][1]))
    for rank in ranks:
        assert 8 * sum(t.numel() * t.element_size() for t in rank[arch]["cache"]) == whole


def test_the_recurrent_states_are_held_whole_over_model(served):
    """mamba2's SSD states and conv tails: its rows only (the deviation of
    ROADMAP A14c, part 2)."""
    ranks, one, _ = served
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(one["mamba2-2.7b"][1]))
    for rank in ranks:
        assert 2 * sum(t.numel() * t.element_size() for t in rank["mamba2-2.7b"]["cache"]) == whole


def test_mesh_generate_and_prefill_step(served):
    """``generate`` under ``use_mesh``: each rank's greedy tokens are the
    one-process tokens of its rows; ``make_prefill_step(mesh=)`` gives the
    prefill's logits."""
    ranks, one, cases = served
    case = cases["llama3.2-1b"]
    want = generate(case["cfg"], case["params"], case["batch"]["tokens"], max_new=4)
    for r, rank in enumerate(ranks):
        d = Mesh(MESH, ("data", "model"), rank=r).coords["data"]
        assert torch.equal(rank["generate"], want[d * 2:(d + 1) * 2])
        assert torch.equal(rank["prefill_step"], rank["llama3.2-1b"]["logits"][0])


def test_decode_combines_over_model(served):
    """The decode steps' attention combine runs over ``model`` on the
    position-split archs (counted as its own kind), and not on mamba2."""
    ranks, _, _ = served
    assert all(rank["llama3.2-1b"]["bytes"]["attn_combine"] > 0 for rank in ranks)
    assert all(rank["deepseek-v2-236b"]["bytes"]["attn_combine"] > 0 for rank in ranks)
    assert all(rank["mamba2-2.7b"]["bytes"]["attn_combine"] == 0 for rank in ranks)


def test_a_cache_that_does_not_split_raises():
    cfg = smoke_config("llama3.2-1b")
    with pytest.raises(ValueError, match="does not split"):
        tfm.cache_specs(cfg, B, 33, Mesh(MESH, ("data", "model")))


# ---------------------------------------------------------------------------
# the one-process port against the JAX reference


def test_one_process_serving_matches_the_reference():
    """llama3.2-1b's smoke config in f32: the port's prefill and 3 decode
    steps against the reference's under ``jax.jit`` on the same weights
    (``convert.params_from_reference``)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from functools import partial

    from repro import configs as jconfigs
    from repro.models import transformer as jt
    from repro_torch import convert

    cfg = smoke_config("llama3.2-1b")
    jcfg = jconfigs.smoke_config("llama3.2-1b")
    jp = jt.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    S = S_DEFAULT
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, S + NEW)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, S_cache=S + EXTRA))(jp, {"tokens": toks[:, :S]})
    logits, cache = tfm.prefill(cfg, tp, {"tokens": torch.as_tensor(toks[:, :S])}, S_cache=S + EXTRA)
    step = jax.jit(partial(jt.decode_step, jcfg))
    for i in range(NEW + 1):
        want = torch.as_tensor(np.asarray(jlogits))
        assert _rel(logits, want) <= 1e-5, i
        if i == NEW:
            break
        jlogits, jcache = step(jp, jcache, jnp.asarray(toks[:, S + i]), jnp.asarray(S + i, jnp.int32))
        logits, cache = tfm.decode_step(cfg, tp, cache, torch.as_tensor(toks[:, S + i]), S + i)
