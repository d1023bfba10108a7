"""Port parity: ``repro_torch.models`` (the LM substrate) and
``repro_torch.configs`` against ``repro.models`` and ``repro.configs``.

Every arch runs at its smoke size, f32, on the CPU: llama3.2-1b,
qwen3-0.6b (qk-norm), mistral-nemo-12b (H·hd < d_model), nemotron-4-15b
(squared ReLU, not gated), musicgen-medium (the ``frames`` front end,
``gelu``, H = KV), mixtral-8x7b (MoE, sliding window), deepseek-v2-236b
(MLA, MoE with a shared expert, a dense prefix layer), mamba2-2.7b (SSD),
recurrentgemma-9b (RG-LRU + local MQA, a suffix) and llama-3.2-vision-11b
(cross-attention, the ``vision`` front end; its tanh gates are set to
0.3–0.7, since at their zero init the cross-attention adds nothing).  The
reference's parameters cross through ``convert.params_from_reference`` and
its batches through ``convert.batch_from_reference``; the inputs are drawn
with numpy.  The serving tests run the MoE archs at capacity factor 8.0,
the drop-free regime of ``tests/test_serving_consistency.py`` (capacity
drops depend on the batch, so a decode step and a forward drop differently
below it); forward, loss and gradients run them at the published 1.25,
with drops.

Tolerances:
- ``forward``'s logits: 2e-5 absolute + 1e-5 relative (f32 products
  summed in other orders, measured ≤ 6e-6 on logits of size ≤ 4);
- ``loss_fn``'s loss and its MoE aux term: 1e-5 relative; its gradient,
  leaf by leaf under the same names as ``jax.value_and_grad``'s: 1e-4
  relative + 1e-5 of the leaf's largest entry (measured ≤ 2e-6 of it);
- ``prefill`` + ``decode_step``: 2e-3, the contract of
  ``tests/test_serving_consistency.py``, against the port's own ``forward``
  and against the reference's serving outputs; also with a 16-token window
  whose ring cache is shorter than the prompt;
- ``remat`` none/full/dots: the same loss and gradients, bitwise.

The reference's computations run under ``jax.jit`` (four times faster on
the CPU than eager, so each file stays near a minute on one worker).
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import LayerSpec, smoke_config  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import tree_get, tree_leaves, tree_map, tree_paths  # noqa: E402

PORTED = ["llama3.2-1b", "qwen3-0.6b", "mistral-nemo-12b", "nemotron-4-15b", "musicgen-medium",
          "mixtral-8x7b", "deepseek-v2-236b", "mamba2-2.7b", "recurrentgemma-9b", "llama-3.2-vision-11b"]
B, S = 2, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test workers at once, and more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keystr(path):
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _drop_free(cfg):
    """``cfg`` with the MoE at capacity factor 8.0 (no assignment dropped)."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _open_gates(cfg, jp):
    """The cross-attention layers' tanh gates set to 0.3–0.7 (zero at init)."""
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "cross_attn":
            gate = jp["pattern"][i]["mixer"]["gate"]
            jp["pattern"][i]["mixer"]["gate"] = jnp.linspace(0.3, 0.7, gate.size, dtype=gate.dtype).reshape(gate.shape)
    return jp


def _pair(arch, cfg=None, key=0):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg = cfg or smoke_config(arch)
    jcfg = jconfigs.smoke_config(arch).replace(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                                                  if f.name in ("pattern", "n_periods", "remat", "moe")})
    jp = _open_gates(cfg, jt.init_params(jcfg, jax.random.key(key)))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, tp


def _image(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)


def _batch(cfg, seq=S, seed=1):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.frontend == "frames":
        out["embeds"] = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    if cfg.frontend == "vision":
        out["image_embeds"] = _image(cfg)
    return out


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_configs_are_the_references(arch):
    assert configs.list_archs() == jconfigs.list_archs()
    for fn in ("get_config", "smoke_config"):
        mine, theirs = getattr(configs, fn)(arch), getattr(jconfigs, fn)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), (arch, fn)
    assert configs.cells(arch) == jconfigs.cells(arch)


@pytest.mark.parametrize("arch", PORTED)
def test_parameter_tree_is_the_references(arch):
    cfg = smoke_config(arch)
    tp = tt.init_params(cfg, 0, device="cpu")
    jshapes = jt.params_shapes(jconfigs.smoke_config(arch))
    want = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = {_keystr(p): tuple(tree_get(tp, p).shape) for p in tree_paths(tp)}
    assert list(got) == list(want)  # names and flatten order
    assert got == want
    assert all(t.dtype == torch.float32 for t in tree_leaves(tp))
    assert tt.params_axes(cfg) == jt.params_axes(jconfigs.smoke_config(arch))
    assert tt.cache_axes(cfg) == jt.cache_axes(jconfigs.smoke_config(arch))


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_the_reference(arch):
    cfg, jcfg, jp, tp = _pair(arch)
    batch = _batch(cfg)
    want = np.asarray(jax.jit(lambda p, b: jt.forward(jcfg, p, b))(jp, batch))
    got = tt.forward(cfg, tp, convert.batch_from_reference(batch, device="cpu"))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def _port_loss_and_grads(cfg, params, batch):
    paths = list(tree_paths(params))
    leaves = [tree_get(params, p).detach().clone().requires_grad_() for p in paths]
    live = tree_map(lambda _: None, params)
    for path, leaf in zip(paths, leaves):
        tree_get(live, path[:-1])[path[-1]] = leaf
    loss, metrics = tt.loss_fn(cfg, live, convert.batch_from_reference(batch, device="cpu"))
    return loss, metrics, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_gradients_match_the_reference(arch):
    cfg, jcfg, jp, tp = _pair(arch)
    batch = _batch(cfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(lambda p: jt.loss_fn(jcfg, p, batch), has_aux=True))(jp)
    loss, metrics, grads = _port_loss_and_grads(cfg, tp, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"].detach()), float(jm["aux"]), rtol=1e-5)
    assert (float(jm["aux"]) > 0) == (cfg.moe is not None)
    jflat = {jax.tree_util.keystr(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert [_keystr(p) for p in grads] == list(jflat)
    for path, g in grads.items():
        want = jflat[_keystr(path)]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=_keystr(path))


def test_loss_chunks_do_not_change_the_loss():
    cfg, _, _, tp = _pair("llama3.2-1b")
    batch = convert.batch_from_reference(_batch(cfg), device="cpu")
    whole, _ = tt.loss_fn(cfg.replace(loss_chunk=0), tp, batch)
    for chunk in (64, 16, 24):  # 24 does not divide 64: the reference steps down to 16
        chunked, _ = tt.loss_fn(cfg.replace(loss_chunk=chunk), tp, batch)
        torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=0)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_same_gradients(remat):
    cfg, _, _, tp = _pair("qwen3-0.6b")
    batch = _batch(cfg)
    l0, _, g0 = _port_loss_and_grads(cfg.replace(remat="none"), tp, batch)
    l1, _, g1 = _port_loss_and_grads(cfg.replace(remat=remat), tp, batch)
    assert torch.equal(l0, l1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


def _serve_inputs(cfg, seq):
    rng = np.random.default_rng(2)
    if cfg.frontend == "frames":
        embeds = rng.standard_normal((B, seq + 4, cfg.d_model)).astype(np.float32)
        return {"embeds": embeds[:, :seq]}, embeds
    toks = rng.integers(0, cfg.vocab, (B, seq + 4)).astype(np.int32)
    batch = {"tokens": toks[:, :seq]}
    if cfg.frontend == "vision":
        batch["image_embeds"] = _image(cfg)
    return batch, toks


def _img(cfg):
    """decode_step's ``img=`` for the vision front end, else None."""
    return torch.as_tensor(_image(cfg)) if cfg.frontend == "vision" else None


def _next(cfg, full, t):
    """Decode inputs for position t: (tokens, embeds)."""
    if cfg.frontend == "frames":
        return None, torch.as_tensor(full[:, t])
    return torch.as_tensor(full[:, t]), None


def _prefix(cfg, full, n):
    key = "embeds" if cfg.frontend == "frames" else "tokens"
    batch = {key: full[:, :n]}
    if cfg.frontend == "vision":
        batch["image_embeds"] = _image(cfg)
    return convert.batch_from_reference(batch, device="cpu")


SERVE = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_forward(arch):
    """The serving contract: prefill's last logits are forward's at S − 1,
    and each decode step's are forward's over the longer prefix."""
    cfg, _, _, tp = _pair(arch, _drop_free(smoke_config(arch)))
    batch, full = _serve_inputs(cfg, S)
    logits, cache = tt.prefill(cfg, tp, convert.batch_from_reference(batch, device="cpu"), S_cache=S + 8)
    torch.testing.assert_close(logits, tt.forward(cfg, tp, _prefix(cfg, full, S))[:, -1], **SERVE)
    for t in range(S, S + 3):
        tokens, embeds = _next(cfg, full, t)
        logits, cache = tt.decode_step(cfg, tp, cache, tokens, t, embeds=embeds, img=_img(cfg))
        torch.testing.assert_close(logits, tt.forward(cfg, tp, _prefix(cfg, full, t + 1))[:, -1], **SERVE)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_the_references(arch):
    """The logits and every cache leaf (KV, MLA's latent and k_rope, the
    recurrent states and convolution tails, their dtypes) after prefill and
    after a decode step."""
    cfg, jcfg, jp, tp = _pair(arch, _drop_free(smoke_config(arch)))
    batch, full = _serve_inputs(cfg, S)
    jlogits, jcache = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, S_cache=S + 8))(jp, batch)
    logits, cache = tt.prefill(cfg, tp, convert.batch_from_reference(batch, device="cpu"), S_cache=S + 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **SERVE)
    _caches_close(cache, jcache)
    tokens, embeds = _next(cfg, full, S)
    jargs = dict(embeds=jnp.asarray(full[:, S])) if cfg.frontend == "frames" else {}
    if cfg.frontend == "vision":
        jargs["img"] = jnp.asarray(_image(cfg))
    jlogits, jcache = jax.jit(partial(jt.decode_step, jcfg))(
        jp, jcache, None if "embeds" in jargs else jnp.asarray(full[:, S]), jnp.asarray(S, jnp.int32), **jargs)
    logits, cache = tt.decode_step(cfg, tp, cache, tokens, S, embeds=embeds, img=_img(cfg))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **SERVE)
    _caches_close(cache, jcache)


def _caches_close(cache, jcache):
    jflat = {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert [_keystr(p) for p in tree_paths(cache)] == list(jflat)
    for path in tree_paths(cache):
        got, want = tree_get(cache, path), jflat[_keystr(path)]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, _keystr(path)
        np.testing.assert_allclose(got.numpy(), want, **SERVE, err_msg=_keystr(path))


@pytest.mark.parametrize("reference", [False, True])
def test_the_ring_buffer_cache(reference):
    """llama3.2-1b's smoke config with a 16-token window: the ring cache (16
    slots) is shorter than the 64-token prompt; decode steps wrap it."""
    cfg = smoke_config("llama3.2-1b").replace(pattern=(LayerSpec("attn", window=16),))
    cfg, jcfg, jp, tp = _pair("llama3.2-1b", cfg)
    batch, full = _serve_inputs(cfg, S)
    logits, cache = tt.prefill(cfg, tp, convert.batch_from_reference(batch, device="cpu"), S_cache=S + 8)
    assert cache["pattern"][0]["k"].shape[3] == 16
    if reference:
        jlogits, jcache = jt.prefill(jcfg, jp, batch, S_cache=S + 8)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **SERVE)
    else:
        torch.testing.assert_close(logits, tt.forward(cfg, tp, _prefix(cfg, full, S))[:, -1], **SERVE)
    for t in range(S, S + 4):
        tokens, _ = _next(cfg, full, t)
        logits, cache = tt.decode_step(cfg, tp, cache, tokens, t)
        if reference:
            jlogits, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(full[:, t]), jnp.asarray(t, jnp.int32))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **SERVE)
            np.testing.assert_allclose(cache["pattern"][0]["v"].numpy(), np.asarray(jcache["pattern"][0]["v"]),
                                       **SERVE)
        else:
            torch.testing.assert_close(logits, tt.forward(cfg, tp, _prefix(cfg, full, t + 1))[:, -1], **SERVE)


def test_init_params_is_seeded_per_leaf():
    cfg = smoke_config("llama3.2-1b")
    a, b = tt.init_params(cfg, 0, device="cpu"), tt.init_params(cfg, 0, device="cpu")
    c = tt.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c)):
        assert torch.equal(x, y)
        assert torch.equal(x, z) == (not x.any())  # the zero-init norms alone agree
    wq = a["pattern"][0]["mixer"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.05  # fan-in init
    assert abs(float(a["embed"].std()) / 0.02 - 1) < 0.05
    deeper = tt.init_params(cfg.replace(n_periods=3), 0, device="cpu")
    assert torch.equal(deeper["embed"], a["embed"])  # a leaf's draw is its own


def test_transformer_module_holds_the_tree_as_parameters():
    cfg, _, _, tp = _pair("qwen3-0.6b")
    model = tt.Transformer(cfg, tp)
    tree = model.params()
    assert [_keystr(p) for p in tree_paths(tree)] == [_keystr(p) for p in tree_paths(tp)]
    assert all(isinstance(t, torch.nn.Parameter) for t in tree_leaves(tree))
    assert tree["pattern"][0]["mixer"]["wq"].data_ptr() == tp["pattern"][0]["mixer"]["wq"].data_ptr()
    assert sum(p.numel() for p in model.parameters()) == sum(t.numel() for t in tree_leaves(tp))
    batch = convert.batch_from_reference(_batch(cfg), device="cpu")
    assert torch.equal(model(batch), tt.forward(cfg, tp, batch))
    loss, _ = model.loss(batch)
    loss.backward()
    assert model.root.pattern[0].mixer.wq.grad.shape == (2, 128, 128)


def test_params_from_reference_checks_shapes():
    cfg = smoke_config("llama3.2-1b")
    jp = jax.tree.map(np.asarray, jt.init_params(jconfigs.smoke_config("llama3.2-1b"), jax.random.key(0)))
    jp["final_ln"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="final_ln"):
        convert.params_from_reference(cfg, jp, device="cpu")


def test_bf16_parameters_cross_exactly():
    cfg = smoke_config("llama3.2-1b").replace(dtype="bfloat16")
    jp = jt.init_params(jconfigs.smoke_config("llama3.2-1b").replace(dtype="bfloat16"), jax.random.key(0))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(), np.asarray(jp["embed"], np.float32))
