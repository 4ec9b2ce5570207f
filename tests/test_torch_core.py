"""PyTorch port vs JAX reference: core/se3, core/camera, core/geometry.

Same seeded numpy inputs through both; float32 on the CPU on both sides.
Tolerances are a few float32 ulps of the magnitudes involved (1e-5 .. 1e-6):
the port keeps the reference's operation order, what differs is XLA's fusion
(FMA contraction) and the libm behind sin/cos/atan2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.core import camera as jcam
from sdvl_tpu.core import geometry as jgeo
from sdvl_tpu.core import se3 as jse3
from sdvl_tpu_torch.core import camera as tcam
from sdvl_tpu_torch.core import geometry as tgeo
from sdvl_tpu_torch.core import se3 as tse3
from sdvl_tpu.pipeline import config as jconfig
from sdvl_tpu.state import map_state as jmap
from sdvl_tpu_torch.pipeline import config as tconfig
from sdvl_tpu_torch.state import map_state as tmap
from torch_port_helpers import N, T

torch.set_num_threads(1)


def _poses(rng, n, small=False):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi *= 1e-4 if small else np.float32(0.7)
    return xi


@pytest.mark.parametrize("small", [False, True])
def test_exp_log(small):
    rng = np.random.default_rng(1)
    xi = _poses(rng, 64, small)
    pj = np.asarray(jse3.exp(jnp.asarray(xi)))
    pt = tse3.exp(T(xi))
    np.testing.assert_allclose(N(pt), pj, atol=2e-6)
    np.testing.assert_allclose(N(tse3.log(pt)),
                               np.asarray(jse3.log(jnp.asarray(pj))),
                               atol=5e-6)
    # and the round trip in the port itself
    np.testing.assert_allclose(N(tse3.log(pt)), xi, atol=2e-5)


def test_exp_zero_is_identity():
    p = tse3.exp(torch.zeros(3, 6))
    np.testing.assert_allclose(N(p), N(tse3.identity((3,))), atol=0)


def test_group_ops():
    rng = np.random.default_rng(2)
    a = np.asarray(jse3.exp(jnp.asarray(_poses(rng, 32))))
    b = np.asarray(jse3.exp(jnp.asarray(_poses(rng, 32))))
    pts = rng.normal(size=(32, 5, 3)).astype(np.float32) * 3
    xi = _poses(rng, 32) * np.float32(0.1)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = T(a), T(b)
    np.testing.assert_allclose(N(tse3.compose(ta, tb)),
                               np.asarray(jse3.compose(ja, jb)), atol=2e-6)
    np.testing.assert_allclose(N(tse3.inverse(ta)),
                               np.asarray(jse3.inverse(ja)), atol=2e-6)
    np.testing.assert_allclose(
        N(tse3.transform(ta[:, None, :], T(pts))),
        np.asarray(jse3.transform(ja[:, None, :], jnp.asarray(pts))),
        atol=5e-6)
    np.testing.assert_allclose(N(tse3.boxplus(ta, T(xi))),
                               np.asarray(jse3.boxplus(ja, jnp.asarray(xi))),
                               atol=2e-6)
    np.testing.assert_allclose(N(tse3.rotation(ta)),
                               np.asarray(jse3.rotation(ja)), atol=1e-6)
    np.testing.assert_allclose(N(tse3.translation(ta)), a[:, 4:], atol=0)
    np.testing.assert_allclose(N(tse3.hat(T(xi[:, 3:]))),
                               np.asarray(jse3.hat(jnp.asarray(xi[:, 3:]))),
                               atol=0)


def test_normalize_canonical_sign():
    q = np.array([[-2.0, 0, 0, 0, 1, 2, 3], [0.5, 0.5, 0.5, 0.5, 0, 0, 0]],
                 np.float32)
    np.testing.assert_allclose(N(tse3.normalize(T(q))),
                               np.asarray(jse3.normalize(jnp.asarray(q))),
                               atol=1e-7)
    assert (N(tse3.normalize(T(q)))[:, 0] >= 0).all()


def _intr():
    kw = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
              dist=[0.1, -0.05, 0.001, -0.002, 0.01], width=640, height=480)
    return jcam.Intrinsics.create(**kw), tcam.Intrinsics.create(**kw)


def test_project_unproject_in_bounds():
    ij, it = _intr()
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[:5, 2] = 0.0                       # z = 0: safe-z branch
    pj = np.asarray(jcam.project(ij, jnp.asarray(pts)))
    pt = N(tcam.project(it, T(pts)))
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(
        N(tcam.project_unit_plane(T(pts))),
        np.asarray(jcam.project_unit_plane(jnp.asarray(pts))), rtol=1e-6)
    px = rng.uniform(-50, 700, size=(300, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tcam.unproject(it, T(px))),
                               np.asarray(jcam.unproject(ij, jnp.asarray(px))),
                               atol=1e-6)
    for level, margin in [(0, 0.0), (0, 6.0), (2, 3.0), (4, 1.5)]:
        np.testing.assert_array_equal(
            N(tcam.in_bounds(it, T(px), margin=margin, level=level)),
            np.asarray(jcam.in_bounds(ij, jnp.asarray(px), margin=margin,
                                      level=level)))


def test_undistort_map_and_distortion():
    ij, it = _intr()
    ij = ij._replace(width=64, height=48)
    it = it._replace(width=64, height=48)
    gj = np.asarray(jcam.undistort_map(ij))
    gt = N(tcam.undistort_map(it, device="cpu"))
    assert gt.shape == (48, 64, 2)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-3)
    assert tcam.has_distortion(it) and jcam.has_distortion(ij)
    assert not tcam.has_distortion(tcam.Intrinsics.create(1, 1, 0, 0))


def test_jacobian_unit_plane():
    rng = np.random.default_rng(4)
    p = rng.normal(size=(100, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.3
    np.testing.assert_allclose(
        N(tgeo.jacobian_unit_plane(T(p))),
        np.asarray(jgeo.jacobian_unit_plane(jnp.asarray(p))),
        rtol=1e-6, atol=1e-6)


def test_masked_median():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(7, 33)).astype(np.float32)
    m = rng.uniform(size=(7, 33)) < 0.6
    m[0] = False                                   # empty row -> 0
    np.testing.assert_array_equal(
        N(tgeo.masked_median(T(v), T(m))),
        np.asarray(jgeo.masked_median(jnp.asarray(v), jnp.asarray(m))))


@pytest.mark.parametrize("n_valid", [40, 5, 3, 0])
def test_sample_without_replacement_same_noise(n_valid):
    """Both sides get the SAME Gumbel noise (the JAX draw), so the indices
    must be identical, including the index-order tail when fewer than k
    entries are valid (stable top-k over equal -inf scores)."""
    n, k = 40, 5
    valid = np.zeros(n, bool)
    valid[np.random.default_rng(6).permutation(n)[:n_valid]] = True
    key = jax.random.PRNGKey(11)
    g = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
    want = np.asarray(jgeo.sample_without_replacement(
        key, jnp.asarray(valid), k))
    got = N(tgeo.sample_without_replacement(T(g), T(valid), k))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == k


# ------------------------------------------------------- config and state
@pytest.mark.parametrize("name", ["tum_f1", "euroc", "zurich"])
def test_load_cfg_matches_reference(name):
    """The port's own copy of the config loader reads the repo's preset
    files to the same values, every field included."""
    import dataclasses
    import os
    import warnings

    path = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                        f"{name}.cfg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cj, ct = jconfig.load_cfg(path), tconfig.load_cfg(path)
    assert dataclasses.asdict(ct.camera) == dataclasses.asdict(cj.camera)
    assert dataclasses.asdict(ct.video) == dataclasses.asdict(cj.video)
    dj, dt = dataclasses.asdict(cj.sdvl), dataclasses.asdict(ct.sdvl)
    assert dt == dj
    ij, it = jconfig.intrinsics(cj), tconfig.intrinsics(ct)
    assert (it.fx, it.fy, it.cx, it.cy) == tuple(
        float(v) for v in (ij.fx, ij.fy, ij.cx, ij.cy))
    assert (it.width, it.height) == (ij.width, ij.height)
    hash(ct.sdvl)                                   # stays hashable


def test_use_pallas_detect_key_sets_use_fused_detect(tmp_path):
    cfg = tmp_path / "k.cfg"
    cfg.write_text("%YAML:1.0\nSDVL.use_pallas_detect: 1\n"
                   "SDVL.localize_only: false\nSDVL.max_matches: 77\n")
    c = tconfig.load_cfg(str(cfg))
    assert c.sdvl.localize_only is False and c.sdvl.max_matches == 77
    # the key sets the reference's field: the detection route's border rule
    assert c.sdvl.use_pallas_detect is True
    assert not hasattr(c.sdvl, "use_fused_detect")
    assert tconfig.SdvlConfig().use_pallas_detect is False


def test_empty_map_and_store_pyramid():
    mj = jmap.empty_map(4, 32, 16, (48, 64), 3)
    mt = tmap.empty_map(4, 32, 16, (48, 64), 3, device="cpu")
    assert mt._fields == mj._fields
    assert mt.capacities == tuple(mj.capacities) == (4, 32, 16)
    for name in mj._fields:
        vj, vt = getattr(mj, name), getattr(mt, name)
        if name == "kf_pyr":
            assert [tuple(p.shape) for p in vt] == [tuple(p.shape) for p in vj]
            assert all(p.dtype == torch.uint8 for p in vt)
            continue
        assert tuple(vt.shape) == tuple(vj.shape), name
        np.testing.assert_array_equal(N(vt), np.asarray(vj), err_msg=name)
        assert vt.dtype == tmap.FIELD_DTYPES[name], name
    rng = np.random.default_rng(8)
    pyr = [rng.uniform(-20, 280, (48 >> l, 64 >> l)).astype(np.float32)
           for l in range(3)]
    pyr[0][0, :4] = [0.5, 1.5, 2.5, 254.5]          # ties round to even
    sj = jmap.store_pyramid([jnp.asarray(p) for p in pyr])
    st = tmap.store_pyramid([T(p) for p in pyr])
    for a, b in zip(st, sj):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(N(a), np.asarray(b))
