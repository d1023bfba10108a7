"""Port parity: the expert-parallel MoE (``repro_torch.models.moe``'s
``_moe_shard_map``, taken by ``moe_apply`` under a mesh with a ``model``
axis) against the JAX reference's ``moe_apply``.

The reference runs in one subprocess on 8 forced host devices, as its own
``tests/test_multidevice.py::test_moe_shard_map_matches_gspmd`` does: the
smoke configs at the drop-free capacity 4.0, the first pattern layer's FFN
from ``init_params(key(0))``, x a (8, 16, D) f32 normal draw of
``key(1)``; the global dispatch (``"gspmd"``) and the shard_map path with
its aux loss, under its mesh.  The port runs on one CPU gloo world of 8
ranks (``tests/test_torch_distributed.py:run_world``) with the meshes
(2, 4), (4, 2) and (1, 8) over it: each rank takes its blocks of the
reference's weights (``mesh_specs`` of ``moe_specs``) and its data rows of
x.

- expert mode: mixtral at tp 4 (one of its 4 smoke experts a rank) and
  deepseek at tp 2 (two experts a rank, plus its shared expert split over
  ``model``); FFN mode: mixtral's 4 experts on (1, 8), each rank an eighth
  of every expert's FFN dim;
- the rows assembled from the ranks within 1e-4 of the reference's global
  dispatch (its test's tolerance), the same rows on every model rank, and
  the aux loss (the mean over ``data`` of each shard's) within 1e-6
  relative of the reference's shard_map aux.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.sharding import Mesh, use_mesh  # noqa: E402

from test_torch_distributed import run_reference, run_world  # noqa: E402

# case: (arch, mesh shape), expert mode where the experts divide the model axis
CASES = {
    "mixtral_tp4": ("mixtral-8x7b", (2, 4)),
    "deepseek_tp2": ("deepseek-v2-236b", (4, 2)),
    "mixtral_ffn_tp8": ("mixtral-8x7b", (1, 8)),
}
TOL = 1e-4  # tests/test_multidevice.py::test_moe_shard_map_matches_gspmd

REFERENCE = """
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.models import init_params
from repro.models.moe import moe_apply

out = {}
for case, (arch, shape) in %(cases)r.items():
    cfg = smoke_config(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    mesh = jax.make_mesh(shape, ("data", "model"))
    params = init_params(cfg, jax.random.key(0))
    p0 = jax.tree.map(lambda a: a[0], params["pattern"][0]["ffn"])
    x = jax.random.normal(jax.random.key(1), (8, 16, cfg.d_model), jnp.float32)
    out[case + "/x"] = np.asarray(x)
    for k, v in p0.items():
        out[case + "/p/" + k] = np.asarray(v)
    out[case + "/gspmd"] = np.asarray(moe_apply(p0, x, cfg.replace(moe_impl="gspmd")))
    with mesh:
        y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg.replace(moe_impl="shard_map"), return_aux=True))(p0, x)
    out[case + "/shard_map"], out[case + "/aux"] = np.asarray(y), np.asarray(aux)
np.savez(%(path)r, **out)
"""

RANK_BODY = """
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.common import mesh_specs
from repro_torch.sharding import PartitionSpec, use_mesh, collectives as col

ref = np.load(f"{tmp}/../ref.npz")
meshes = {}
for case, (arch, shape) in %(cases)r.items():
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"))
    mesh = meshes[shape]
    cfg = smoke_config(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0), moe_impl="shard_map")
    specs = mesh_specs(moe.moe_specs(cfg), mesh)
    p = {k: col.shard_block(torch.as_tensor(ref[case + "/p/" + k]), specs[k], mesh) for k in specs}
    x = col.shard_block(torch.as_tensor(ref[case + "/x"]), PartitionSpec("data", None, None), mesh)
    with use_mesh(mesh):
        y, aux = moe.moe_apply(p, x, cfg, return_aux=True)
    results[case] = dict(y=y, aux=float(aux), coords=mesh.coords, expert_rows=p["w_in"].shape)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh")
    run_reference(REFERENCE % dict(cases=CASES, path=str(tmp / "ref.npz")), devices=8)
    out = run_world(tmp / "world8", 8, RANK_BODY % dict(cases=CASES), timeout=240.0)
    return dict(np.load(tmp / "ref.npz")), out


@pytest.mark.parametrize("case", list(CASES))
def test_shard_map_matches_the_references_moe(worlds, case):
    ref, ranks = worlds
    arch, (n_dp, tp) = CASES[case]
    cfg = smoke_config(arch)
    rows = 8 // n_dp
    y = np.zeros_like(ref[case + "/gspmd"])
    for rank in ranks:
        c = rank[case]["coords"]
        y[c["data"] * rows:(c["data"] + 1) * rows] = rank[case]["y"].numpy()
        peer = ranks[c["data"] * tp]  # the first model rank of the same data row
        assert torch.equal(rank[case]["y"], peer[case]["y"])  # the combine sum gives every model rank the rows
        assert rank[case]["aux"] == pytest.approx(float(ref[case + "/aux"]), rel=1e-6)
    err = float(np.abs(y - ref[case + "/gspmd"]).max())
    assert err < TOL, (case, err)
    np.testing.assert_allclose(y, ref[case + "/shard_map"], rtol=0, atol=TOL)
    E, F = cfg.moe.n_experts, cfg.moe.d_expert
    expert_mode = E % tp == 0
    assert tuple(ranks[0][case]["expert_rows"]) == ((E // tp, cfg.d_model // n_dp, F) if expert_mode
                                                     else (E, cfg.d_model // n_dp, F // tp))


def test_a_mesh_without_a_model_axis_raises():
    cfg = smoke_config("mixtral-8x7b")
    p = {k: torch.zeros(s.shape) for k, s in tmoe.moe_specs(cfg).items()}
    x = torch.zeros(1, 4, cfg.d_model)
    with use_mesh(Mesh((8,), ("data",), rank=0, groups={})):
        with pytest.raises(RuntimeError, match="requires a mesh with a 'model' axis"):
            tmoe.moe_apply(p, x, cfg.replace(moe_impl="shard_map"))
        with pytest.raises(NotImplementedError, match="global dispatch over the ranks"):
            tmoe.moe_apply(p, x, cfg)
    # neither the experts (3) nor their FFN dim (65) split over 4 ranks
    odd = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=3, d_expert=65))
    assert not tmoe._ffn_shardable(odd, 4) and tmoe._ffn_shardable(cfg, 4) and tmoe._ffn_shardable(cfg, 8)
