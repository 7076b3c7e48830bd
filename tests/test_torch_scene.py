"""The port's numpy host compile (raytracingproject_tpu_torch/models/)
against the JAX package's Scene.device_update + make_kernel_globals:
array-equal tables and equal statics for the glossy Cornell box, and a
lossless kg_from_jax conversion."""

import numpy as np
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models import shader_nodes as sn
from raytracingproject_tpu_torch.models.scene import KG_ARRAYS, kg_from_jax
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    js = jex.cornell_box(64, 64, spp=2, spheres="glossy")
    js.device_update()
    jkg = js.make_kernel_globals(device_put=False)
    ts = tex.cornell_box(64, 64, spp=2, spheres="glossy")
    ts.device_update()
    return jkg, ts.make_kernel_globals("cpu")


@pytest.mark.parametrize("name", KG_ARRAYS)
def test_scene_arrays_equal(pair, name):
    jkg, tkg = pair
    ref = np.asarray(jkg["dscene"][name])
    got = tkg["dscene"][name].numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def test_filter_table_equal(pair):
    jkg, tkg = pair
    np.testing.assert_array_equal(np.asarray(jkg["filter_table"]),
                                  tkg["filter_table"].numpy())


def test_statics_equal(pair):
    jkg, tkg = pair
    assert set(jkg["cam"]) == set(tkg["cam"])
    for k, v in jkg["cam"].items():
        got = np.asarray(tkg["cam"][k])
        assert np.asarray(v).dtype == got.dtype, k
        np.testing.assert_array_equal(np.asarray(v), got, err_msg=k)
    assert jkg["kint"] == tkg["kint"]
    for k in ("cluster_tris", "use_brute", "light_kinds"):
        assert jkg[k] == tkg[k], k
    assert tkg["cluster_tris"] == 15 and tkg["use_brute"] is False
    assert tkg["light_kinds"] == ("tri", "tri")


def test_shader_slots_and_nodes_equal(pair):
    jkg, tkg = pair
    assert [s.name for s in jkg["shaders"]] == [s.name for s in tkg["shaders"]]
    for js, ts in zip(jkg["shaders"], tkg["shaders"]):
        assert js.slot == ts.slot
        jn = [type(n).__name__ for n in js.graph.nodes]
        tn = [type(n).__name__ for n in ts.graph.nodes]
        assert jn == tn


def test_kg_from_jax_round_trip(pair):
    """Converted kernel globals carry the same arrays and render the same
    image bit for bit as the port's own compile."""
    jkg, tkg = pair
    ckg = kg_from_jax(jkg, "cpu")
    for k in KG_ARRAYS:
        assert torch.equal(ckg["dscene"][k], tkg["dscene"][k]), k
    assert all(isinstance(n, tuple(sn.EVALS)) for s in ckg["shaders"]
               for n in s.graph.nodes if n is not s.graph.output_node)
    px, py, pidx = pixel_wavefront(8, 8, 1, "cpu")
    a = integ.render_samples_regen(ckg, px, py, pidx, 0, 1)[0]
    b = integ.render_samples_regen(tkg, px, py, pidx, 0, 1)[0]
    assert torch.equal(a, b)


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        tex.cornell_box(16, 16, spheres="glass")
    with pytest.raises(NotImplementedError):
        tex.cornell_box(16, 16, light_mode="area")
    # the plain two-box Cornell (36 prims) compiles for the dense sweep
    # (K1): use_brute, and no cluster tables under CLUSTER_MIN_PRIMS
    plain = tex.cornell_box(16, 16)
    plain.device_update()
    kg = plain.make_kernel_globals("cpu")
    assert kg["use_brute"] and kg["cluster_tris"] == 0
    assert "cluster_table" not in kg["dscene"]
    assert kg["dscene"]["tri_verts_world"].shape == (36, 3, 3)
