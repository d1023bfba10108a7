"""Port parity: ``repro_torch.models.attention`` against ``repro.models.attention``.

The same inputs, drawn with numpy from a seed, go through both packages in
f32 on the CPU.

Tolerances (f32; the two libraries sum the blocks' products in other
orders):
- ``flash_attention`` (windows None/16/64, GQA groups 1 and 4, ``q_offset``,
  the non-causal case) and ``decode_attention``: 1e-5 absolute and relative;
- ``gqa_apply`` / ``gqa_decode`` with and without qk-norm (llama3.2-1b's and
  qwen3-0.6b's smoke configs): 1e-5, the written cache slot included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

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


def _qkv(rng, B, Hkv, G, Sq, Skv, d):
    q = rng.standard_normal((B, Hkv * G, Sq, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window,G,causal", [(w, g, True) for w in (None, 16, 64) for g in (1, 4)]
                         + [(None, 1, False), (None, 4, False)])
def test_flash_attention_matches_the_reference(window, G, causal):
    rng = np.random.default_rng(hash((window, G, causal)) % 2**32)
    q, k, v = _qkv(rng, 2, 2, G, 128, 128, 16)
    kw = dict(causal=causal, window=window, q_block=32, kv_block=32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tattn.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("q_offset", [32, 96])
def test_flash_attention_with_a_query_offset(window, q_offset):
    """Queries at absolute positions q_offset.. against keys from 0 (a
    prompt's tail over its whole cache), with ragged blocks."""
    rng = np.random.default_rng(q_offset)
    Sq = 128 - q_offset
    q, k, v = _qkv(rng, 1, 2, 2, Sq, 128, 16)
    kw = dict(causal=True, window=window, q_offset=q_offset, q_block=16, kv_block=48)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tattn.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    _close(got, want)


@pytest.mark.parametrize("size,want", [(2048, 512), (2049, 3), (64, 64), (7, 7)])
def test_pick_block_is_the_references(size, want):
    assert tattn._pick_block(size, 512) == jattn._pick_block(size, 512) == want


def test_flash_attention_keeps_bf16_and_its_gradient_flows():
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16).requires_grad_() for a in _qkv(rng, 1, 2, 2, 64, 64, 16))
    out = tattn.flash_attention(q, k, v, q_block=16, kv_block=32)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.parametrize("G", [1, 4])
def test_decode_attention_matches_the_reference(G):
    rng = np.random.default_rng(G)
    B, Hkv, S, d = 3, 2, 40, 16
    q = rng.standard_normal((B, Hkv * G, d)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    valid[:, 0] = True
    want = jattn.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, valid)))
    got = tattn.decode_attention(*(torch.as_tensor(a) for a in (q, kc, vc, valid)))
    _close(got, want)


def _layer(arch, key=0):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    jp = jcommon.init_tree(jattn.gqa_specs(jcfg), jax.random.key(key), jnp.float32)
    # scale norms off their zero init so the qk-norm and ln scales matter
    jp = {k: (v + 0.1 * jax.random.normal(jax.random.key(7), v.shape) if v.ndim == 1 else v) for k, v in jp.items()}
    tp = tree_map(lambda a: torch.as_tensor(np.array(a)), jp)
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-0.6b"])  # without and with qk-norm
@pytest.mark.parametrize("window", [None, 16])
def test_gqa_apply_matches_the_reference(arch, window):
    cfg, jcfg, jp, tp = _layer(arch)
    assert ("q_norm" in tp) == cfg.qk_norm
    x = np.random.default_rng(1).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want = jattn.gqa_apply(jp, jnp.asarray(x), jcfg, window=window, pos_offset=5)
    got = tattn.gqa_apply(tp, torch.as_tensor(x), cfg, window=window, pos_offset=5)
    _close(got, want)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-0.6b"])
@pytest.mark.parametrize("window,step", [(None, 5), (None, 40), (16, 5), (16, 37)])
def test_gqa_decode_matches_the_reference(arch, window, step):
    """One token at ``step`` into a filled cache: the output and the cache
    (the ring slot ``step % L`` with a window, ``min(step, L - 1)``
    without)."""
    cfg, jcfg, jp, tp = _layer(arch, key=3)
    rng = np.random.default_rng(step)
    B, S = 2, 32
    L = min(S, window) if window else S
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((B, cfg.n_kv_heads, L, cfg.head_dim)).astype(np.float32) for n in "kv"}
    want_x, want_c = jattn.gqa_decode(jp, jnp.asarray(x), {n: jnp.asarray(a) for n, a in cache.items()},
                                      jnp.asarray(step, jnp.int32), jcfg, window=window)
    tcache = {n: torch.as_tensor(a.copy()) for n, a in cache.items()}
    got_x, got_c = tattn.gqa_decode(tp, torch.as_tensor(x), tcache, step, cfg, window=window)
    assert got_c is tcache  # written in place
    _close(got_x, want_x)
    for n in "kv":
        _close(got_c[n], want_c[n])


def test_init_cache_shapes_follow_the_window():
    cfg = smoke_config("llama3.2-1b")
    assert tattn.gqa_init_cache(cfg, 2, 64, None, torch.float32)["k"].shape == (2, 2, 64, 32)
    assert tattn.gqa_init_cache(cfg, 2, 64, 16, torch.float32)["v"].shape == (2, 2, 16, 32)
    assert tattn.gqa_cache_axes() == jattn.gqa_cache_axes()
