"""Port parity: MLA (DeepSeek-V2's multi-head latent attention) and
cross-attention in ``repro_torch.models.attention`` against
``repro.models.attention``.

The same inputs, drawn with numpy from a seed, go through both packages in
f32 on the CPU: MLA at deepseek-v2-236b's smoke config (4 heads, kv_lora
32, q_lora 48, nope 16 + rope 8, v 16) with the reference's parameters of
its first pattern layer; cross-attention at llama-3.2-vision-11b's (4
heads over 2 KV heads of 32, 16 image patches) with its tanh gate set to
0.5 (zero at init, where the block adds nothing).

Tolerances (f32; the two libraries sum the blocks' products in other
orders):
- ``mla_apply`` / ``cross_apply`` and their gradients: 1e-5, and 1e-4
  relative + 1e-5 of each leaf's largest entry;
- the weight-absorbed ``mla_decode`` against the reference's (the written
  latent and k_rope slots included) and against the last row of
  ``mla_apply`` over the longer sequence (keys expanded per head): 1e-5;
- ``cross_decode`` against the reference's and against ``cross_apply``'s
  row at the same position (the image is a fixed KV): 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test workers at once, and more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _layer(arch, slot):
    """(cfg, reference cfg, the mixer's parameters at pattern slot ``slot``,
    period 0, as numpy)."""
    cfg, jcfg = smoke_config(arch), jconfigs.smoke_config(arch)
    params = jt.init_params(jcfg, jax.random.key(0))
    p = {k: np.array(v[0]) for k, v in params["pattern"][slot]["mixer"].items()}
    if "gate" in p:
        p["gate"] = np.full_like(p["gate"], 0.5)
    return cfg, jcfg, p


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(np.float32)


def _reference_vjp(fn, p, x, ct):
    """The reference's output and (∂/∂p, ∂/∂x) of ⟨output, ct⟩, jitted."""
    def run(pp, xx, cc):
        out, vjp = jax.vjp(fn, pp, xx)
        return out, vjp(cc)

    return jax.jit(run)({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(ct))


def _grads_close(tx, tp, out, proj, jgx, jgp):
    grads = torch.autograd.grad((out * torch.as_tensor(proj)).sum(), [tx, *tp.values()])
    for name, g, want in [("x", grads[0], jgx)] + [(k, g, jgp[k]) for k, g in zip(tp, grads[1:])]:
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), err_msg=name)


# ---- MLA --------------------------------------------------------------------


@pytest.mark.parametrize("pos_offset", [0, 5])
def test_mla_apply_and_its_gradients_match_the_reference(pos_offset):
    cfg, jcfg, p = _layer("deepseek-v2-236b", 0)
    x = _x(cfg, (2, 48), 1)
    proj = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jout, (jgp, jgx) = _reference_vjp(lambda pp, xx: jattn.mla_apply(pp, xx, jcfg, pos_offset=pos_offset),
                                      p, x, proj)
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    out = tattn.mla_apply(tp, tx, cfg, pos_offset=pos_offset)
    _close(out, jout)
    _grads_close(tx, tp, out, proj, jgx, jgp)


def test_mla_decode_matches_the_reference_and_the_expanded_path():
    """A latent cache of 40 slots filled by the prompt's first 32 positions,
    then three absorbed decode steps: each against the reference's step and
    against ``mla_apply``'s row over the prompt and the steps' tokens."""
    cfg, jcfg, p = _layer("deepseek-v2-236b", 0)
    x = _x(cfg, (2, 35), 3)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    with torch.no_grad():
        full = tattn.mla_apply(tp, torch.as_tensor(x), cfg)
        h = tattn.rms_norm(torch.as_tensor(x[:, :32]), tp["ln"], cfg.norm_eps)
        latent, k_rope = tattn.mla_latent(tp, h, cfg, torch.arange(32))
    cache = tattn.mla_init_cache(cfg, 2, 40, torch.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {"latent": (2, 40, 32), "k_rope": (2, 40, 8)}
    cache["latent"][:, :32] = latent
    cache["k_rope"][:, :32] = k_rope
    jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}  # decode writes into cache
    for t in range(32, 35):
        with torch.no_grad():
            got, cache2 = tattn.mla_decode(tp, torch.as_tensor(x[:, t]), cache, t, cfg)
        assert cache2 is cache  # written in place
        want, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, t]), jcache, jnp.asarray(t), jcfg)
        _close(got, want)
        for k in cache:
            _close(cache[k], jcache[k])
        torch.testing.assert_close(got, full[:, t], **TOL)


def test_mla_cache_and_specs_are_the_references():
    cfg, jcfg = smoke_config("deepseek-v2-236b"), jconfigs.smoke_config("deepseek-v2-236b")
    got, want = tattn.mla_init_cache(cfg, 3, 17, torch.bfloat16), jattn.mla_init_cache(jcfg, 3, 17, jnp.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: (v.shape, torch.bfloat16) for k, v in want.items()}
    assert tattn.mla_cache_axes() == jattn.mla_cache_axes()
    for fn in ("mla_specs", "cross_specs"):
        arch = "deepseek-v2-236b" if fn == "mla_specs" else "llama-3.2-vision-11b"
        specs, jspecs = getattr(tattn, fn)(smoke_config(arch)), getattr(jattn, fn)(jconfigs.smoke_config(arch))
        assert list(specs) == list(jspecs)
        assert all((specs[k].shape, specs[k].axes, specs[k].init) == (jspecs[k].shape, jspecs[k].axes,
                                                                       jspecs[k].init) for k in specs)
    assert tt.cache_axes(cfg) == jt.cache_axes(jcfg)


# ---- cross-attention -----------------------------------------------------------


def test_cross_apply_and_its_gradients_match_the_reference():
    cfg, jcfg, p = _layer("llama-3.2-vision-11b", 3)
    x, img = _x(cfg, (2, 40), 4), _x(cfg, (2, cfg.n_patches), 5)
    proj = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    jout, (jgp, jgx) = _reference_vjp(lambda pp, xx: jattn.cross_apply(pp, xx, jnp.asarray(img), jcfg), p, x, proj)
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    out = tattn.cross_apply(tp, tx, torch.as_tensor(img), cfg)
    _close(out, jout)
    _grads_close(tx, tp, out, proj, jgx, jgp)


def test_cross_decode_matches_the_reference_and_cross_apply():
    cfg, jcfg, p = _layer("llama-3.2-vision-11b", 3)
    x, img = _x(cfg, (2, 40), 7), _x(cfg, (2, cfg.n_patches), 8)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    with torch.no_grad():
        full = tattn.cross_apply(tp, torch.as_tensor(x), torch.as_tensor(img), cfg)
        for t in (0, 17, 39):
            got = tattn.cross_decode(tp, torch.as_tensor(x[:, t]), torch.as_tensor(img), cfg)
            want = jattn.cross_decode({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x[:, t]),
                                      jnp.asarray(img), jcfg)
            _close(got, want)
            torch.testing.assert_close(got, full[:, t], **TOL)
    assert not torch.equal(full, torch.as_tensor(x))  # the open gate lets the image in


def test_cross_attention_without_an_image_raises():
    cfg, _, p = _layer("llama-3.2-vision-11b", 3)
    with pytest.raises(ValueError, match="image"):
        tattn.cross_apply({k: torch.as_tensor(v) for k, v in p.items()}, torch.zeros(1, 4, cfg.d_model), None, cfg)
