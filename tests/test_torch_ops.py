"""PyTorch port vs JAX reference: ops/interp, ops/pyramid, ops/fast (plain
route), ops/patch, ops/orb.

Same seeded numpy inputs through both, float32 on the CPU. Gathers and
integer work must agree exactly (corner masks, grid winners, descriptors,
Hamming distances); interpolated and filtered values to a few float32 ulps
of 255 (XLA contracts multiply-adds, torch does not).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.core import camera as jcam
from sdvl_tpu.core import se3 as jse3
from sdvl_tpu.ops import fast as jfast
from sdvl_tpu.ops import interp as jinterp
from sdvl_tpu.ops import orb as jorb
from sdvl_tpu.ops import patch as jpatch
from sdvl_tpu.ops import pyramid as jpyr
from sdvl_tpu_torch.core import camera as tcam
from sdvl_tpu_torch.ops import fast as tfast
from sdvl_tpu_torch.ops import interp as tinterp
from sdvl_tpu_torch.ops import orb as torb
from sdvl_tpu_torch.ops import patch as tpatch
from sdvl_tpu_torch.ops import pyramid as tpyr
from torch_port_helpers import N, T, blocky_image, smooth_image

torch.set_num_threads(1)

ATOL_PX = 2e-4   # a few float32 ulps of 255, through 3 lerps


def _xy(rng, n, H, W, pad=6.0):
    return np.stack([rng.uniform(-pad, W + pad, n),
                     rng.uniform(-pad, H + pad, n)], -1).astype(np.float32)


# ------------------------------------------------------------------ interp
def test_bilinear_nearest_and_grad():
    rng = np.random.default_rng(0)
    img = smooth_image(0, (60, 80))
    xy = _xy(rng, 500, 60, 80)
    for f in ("bilinear", "nearest"):
        np.testing.assert_allclose(
            N(getattr(tinterp, f)(T(img), T(xy))),
            np.asarray(getattr(jinterp, f)(jnp.asarray(img), jnp.asarray(xy))),
            atol=ATOL_PX)
    vj, gj = jinterp.bilinear_with_grad(jnp.asarray(img), jnp.asarray(xy))
    vt, gt = tinterp.bilinear_with_grad(T(img), T(xy))
    np.testing.assert_allclose(N(vt), np.asarray(vj), atol=ATOL_PX)
    np.testing.assert_allclose(N(gt), np.asarray(gj), atol=4 * ATOL_PX)


def test_bilinear_uint8_and_nonfinite_positions():
    """uint8 images convert after the gather; nan/inf positions must not
    fault (torch raises on an out-of-range gather where XLA clamps)."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    xy = _xy(rng, 100, 40, 50)
    np.testing.assert_allclose(
        N(tinterp.bilinear(T(img), T(xy))),
        np.asarray(jinterp.bilinear(jnp.asarray(img), jnp.asarray(xy))),
        atol=ATOL_PX)
    bad = np.array([[np.nan, 3.0], [np.inf, -np.inf], [1e30, 2.0]], np.float32)
    out = N(tinterp.bilinear(T(img), T(bad)))
    assert out.shape == (3,)
    assert N(tinterp.nearest(T(img), T(bad))).shape == (3,)


def test_remap_patches_and_indexed():
    rng = np.random.default_rng(2)
    img = smooth_image(1, (48, 64))
    grid = _xy(rng, 48 * 64, 48, 64).reshape(48, 64, 2)
    np.testing.assert_allclose(
        N(tinterp.remap(T(img), T(grid))),
        np.asarray(jinterp.remap(jnp.asarray(img), jnp.asarray(grid))),
        atol=ATOL_PX)
    c = _xy(rng, 30, 48, 64, pad=0)
    np.testing.assert_array_equal(
        N(tinterp.patch_grid(T(c), 4)),
        np.asarray(jinterp.patch_grid(jnp.asarray(c), 4)))
    np.testing.assert_allclose(
        N(tinterp.extract_patches(T(img), T(c), 4)),
        np.asarray(jinterp.extract_patches(jnp.asarray(img), jnp.asarray(c), 4)),
        atol=ATOL_PX)
    stack = rng.integers(0, 256, (5, 48, 64)).astype(np.uint8)
    k = rng.integers(0, 5, 30)
    np.testing.assert_allclose(
        N(tinterp.bilinear_indexed(T(stack), T(k), T(c))),
        np.asarray(jinterp.bilinear_indexed(jnp.asarray(stack), jnp.asarray(k),
                                            jnp.asarray(c))),
        atol=ATOL_PX)


def test_pyramid_samplers():
    rng = np.random.default_rng(3)
    img = smooth_image(2, (64, 96))
    pj = jpyr.build_pyramid(jnp.asarray(img), 4)
    pt = tpyr.build_pyramid(T(img), 4)
    n = 200
    xy = _xy(rng, n, 64, 96)
    lvl = rng.integers(0, 4, n).astype(np.int32)
    np.testing.assert_allclose(
        N(tinterp.bilinear_pyramid(pt, T(lvl), T(xy))),
        np.asarray(jinterp.bilinear_pyramid(pj, jnp.asarray(lvl),
                                            jnp.asarray(xy))),
        atol=ATOL_PX)
    np.testing.assert_allclose(
        N(tinterp.extract_patches_pyramid(pt, T(lvl), T(xy), 4)),
        np.asarray(jinterp.extract_patches_pyramid(pj, jnp.asarray(lvl),
                                                   jnp.asarray(xy), 4)),
        atol=ATOL_PX)
    # stacked uint8 pyramids with per-element image index and level
    K = 3
    stack_np = [rng.integers(0, 256, (K, 64 >> l, 96 >> l)).astype(np.uint8)
                for l in range(4)]
    k = rng.integers(0, K, n)
    want = np.asarray(jinterp.bilinear_indexed_pyramid(
        tuple(jnp.asarray(s) for s in stack_np), jnp.asarray(k),
        jnp.asarray(lvl), jnp.asarray(xy)))
    stack_t = tuple(T(s) for s in stack_np)
    np.testing.assert_allclose(
        N(tinterp.bilinear_indexed_pyramid(stack_t, T(k), T(lvl), T(xy))),
        want, atol=ATOL_PX)
    # ... and through a pre-flattened store
    flat = tinterp.flatten_pyramid(stack_t)
    assert flat.flat.dtype == torch.uint8
    np.testing.assert_allclose(
        N(tinterp.bilinear_indexed_pyramid(flat, T(k), T(lvl), T(xy))),
        want, atol=ATOL_PX)


# ----------------------------------------------------------------- pyramid
def test_build_pyramid_and_gradient():
    img = blocky_image(0, (120, 160))
    pj = jpyr.build_pyramid(jnp.asarray(img), 5)
    pt = tpyr.build_pyramid(T(img), 5)
    assert [tuple(p.shape) for p in pt] == [tuple(p.shape) for p in pj]
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-4)
    gxj, gyj = jpyr.gradient(jnp.asarray(img))
    gxt, gyt = tpyr.gradient(T(img))
    np.testing.assert_array_equal(N(gxt), np.asarray(gxj))
    np.testing.assert_array_equal(N(gyt), np.asarray(gyj))
    # uint8 input is cast, as the stream feeds it
    u8 = img.astype(np.uint8)
    np.testing.assert_allclose(
        N(tpyr.build_pyramid(T(u8), 3)[2]),
        np.asarray(jpyr.build_pyramid(jnp.asarray(u8), 3)[2]), atol=1e-4)


# -------------------------------------------------------------------- fast
@pytest.mark.parametrize("shape", [(120, 160), (240, 320)])
def test_plain_detection_route(shape):
    """Masks exact, scores 1e-4 (relative): fast_corner_mask with its edge
    pad, shi_tomasi with its roll wrap-around."""
    img = blocky_image(1, shape)
    cj = np.asarray(jfast.fast_corner_mask(jnp.asarray(img), 10.0))
    ct = N(tfast.fast_corner_mask(T(img), 10.0))
    np.testing.assert_array_equal(ct, cj)
    assert cj.sum() > 100
    sj = np.asarray(jfast.shi_tomasi(jnp.asarray(img)))
    st = N(tfast.shi_tomasi(T(img)))
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-2)


_PYRAMID_CASES = [(False, None), (True, None), (True, 20), (False, 12)]


@pytest.mark.parametrize(
    "use_lock,max_features,fused",
    [c + (False,) for c in _PYRAMID_CASES]
    + [c + (True,) for c in _PYRAMID_CASES],
    ids=[f"{a}-{b}" for a, b in _PYRAMID_CASES]
    + [f"fused-{a}-{b}" for a, b in _PYRAMID_CASES])
def test_detect_pyramid(use_lock, max_features, fused, monkeypatch):
    """The port's route (one call of the kernel's wrapper for all levels,
    its plain version on the CPU) against both JAX routes, each under its
    border rule: ``use_pallas=False`` against ``border="plain"``, and
    ``use_pallas=True`` with the Pallas kernel in interpret mode against
    ``border="pallas"``."""
    img = blocky_image(2, (120, 160))
    pj = jpyr.build_pyramid(jnp.asarray(img), 4)
    pt = tpyr.build_pyramid(T(img), 4)
    rng = np.random.default_rng(4)
    kw = dict(levels=3, cell=32, fast_threshold=10.0, st_threshold=50.0,
              max_features=max_features)
    if fused:
        from sdvl_tpu.ops.pallas import detect as pallas_detect

        monkeypatch.setattr(
            pallas_detect, "fast_shi_tomasi_map",
            functools.partial(pallas_detect.fast_shi_tomasi_map,
                              interpret=True))
    lock = {}
    lock_t = {}
    if use_lock:
        xy = np.stack([rng.uniform(-20, 180, 12), rng.uniform(-20, 140, 12)],
                      -1).astype(np.float32)
        xy[0] = [np.nan, 5.0]          # a point projected from z ~ 0
        xy[1] = [np.inf, -np.inf]
        ok = rng.uniform(size=12) < 0.8
        lock = dict(lock_xy=jnp.asarray(xy), lock_valid=jnp.asarray(ok))
        lock_t = dict(lock_xy=T(xy), lock_valid=T(ok))
    cj = jfast.detect_pyramid(pj, **kw, **lock, use_pallas=fused)
    ct = tfast.detect_pyramid(pt, **kw, **lock_t,
                              border="pallas" if fused else "plain")
    vj = np.asarray(cj.valid)
    np.testing.assert_array_equal(N(ct.valid), vj)
    assert vj.sum() >= 5
    # invalid slots are ordered by a tie among -inf keys: compare valid ones
    np.testing.assert_array_equal(N(ct.xy)[vj], np.asarray(cj.xy)[vj])
    np.testing.assert_array_equal(N(ct.level)[vj], np.asarray(cj.level)[vj])
    np.testing.assert_allclose(N(ct.score)[vj], np.asarray(cj.score)[vj],
                               rtol=1e-4)
    if max_features is None:
        # no top-k: every slot in cell order, invalid ones included
        np.testing.assert_array_equal(N(ct.xy), np.asarray(cj.xy))
        np.testing.assert_allclose(N(ct.score), np.asarray(cj.score),
                                   rtol=1e-4)


def test_occupied_cells_in_grid_rule():
    xy = np.array([[5, 5], [100, 70], [159, 119], [150, 100], [-3, 4],
                   [40, 40]], np.float32)
    ok = np.array([1, 1, 1, 1, 1, 0], bool)
    want = np.asarray(jfast.occupied_cells(jnp.asarray(xy), jnp.asarray(ok),
                                           120, 160, 32))
    got = N(tfast.occupied_cells(T(xy), T(ok), 120, 160, 32))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2      # border-remnant and invalid features lock none


# ------------------------------------------------------------------- patch
def test_warp_matrix_and_search_level():
    rng = np.random.default_rng(5)
    kw = dict(fx=210.0, fy=210.0, cx=159.5, cy=119.5, width=320, height=240)
    ij, it = jcam.Intrinsics.create(**kw), tcam.Intrinsics.create(**kw)
    n = 64
    px = _xy(rng, n, 240, 320, pad=0)
    lvl = rng.integers(0, 3, n).astype(np.int32)
    depth = rng.uniform(1.0, 6.0, n).astype(np.float32)
    xi = (rng.normal(size=(n, 6)) * 0.15).astype(np.float32)
    pose = np.asarray(jse3.exp(jnp.asarray(xi)))
    Aj = np.asarray(jpatch.warp_matrix_affine(
        ij, jnp.asarray(px), jnp.asarray(lvl), jnp.asarray(depth),
        jnp.asarray(pose)))
    At = N(tpatch.warp_matrix_affine(it, T(px), T(lvl), T(depth), T(pose)))
    np.testing.assert_allclose(At, Aj, atol=2e-4)   # finite difference / 5px
    # search level on the SAME matrices (scaled to exercise every level)
    A = Aj * rng.uniform(0.5, 12.0, (n, 1, 1)).astype(np.float32)
    A[0] = np.nan                                    # z ~ 0 point
    np.testing.assert_array_equal(
        N(tpatch.search_level_from_warp(T(A), 4)),
        np.asarray(jpatch.search_level_from_warp(jnp.asarray(A), 4)))


# --------------------------------------------------------------------- orb
def test_orb_descriptors_and_hamming_exact():
    rng = np.random.default_rng(6)
    img = blocky_image(3, (120, 160))
    c = np.stack([rng.uniform(16, 144, 80), rng.uniform(16, 104, 80)],
                 -1).astype(np.float32)
    aj = np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(c)))
    at = N(torb.orientations(T(img), T(c)))
    np.testing.assert_allclose(at, aj, atol=1e-5)
    # descriptors at GIVEN angles: integer taps, must be bit-identical
    dj = np.asarray(jorb.descriptors(jnp.asarray(img), jnp.asarray(c),
                                     angles=jnp.asarray(aj)))
    dt = N(torb.descriptors(T(img), T(c), angles=T(aj)))
    assert dj.dtype == np.uint32 and dt.dtype == np.int64
    np.testing.assert_array_equal(dt, dj.astype(np.int64))
    assert (dt >> 31).max() == 1, "bit 31 must be exercised"
    # end to end (own orientations): a rounding flip of a tap is possible,
    # so allow a few bits per descriptor
    dt2 = torb.descriptors(T(img), T(c), radius=15)
    assert int(torb.hamming(dt2, T(dj)).max()) <= 8
    # Hamming exact, on the reference's words, bit 31 included
    a = rng.integers(0, 2 ** 32, (50, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (50, 8), dtype=np.uint64).astype(np.uint32)
    hj = np.asarray(jorb.hamming(jnp.asarray(a), jnp.asarray(b)))
    ht = N(torb.hamming(T(a), T(b)))
    np.testing.assert_array_equal(ht, hj)
    want = np.array([bin(int(x) ^ int(y)).count("1")
                     for x, y in zip(a.ravel(), b.ravel())]
                    ).reshape(50, 8).sum(1)
    np.testing.assert_array_equal(ht, want)


def test_warp_patch_matches_reference():
    """Batched warped patches (random affine maps, centres near and past
    the border) against the reference; the identity map gives the plain
    patch."""
    rng = np.random.default_rng(3)
    img = smooth_image(2, (60, 80))
    A = (np.eye(2, dtype=np.float32)[None]
         + rng.normal(0, 0.3, (5, 2, 2)).astype(np.float32))
    px = _xy(rng, 5, 60, 80)
    want = np.asarray(jpatch.warp_patch(jnp.asarray(img), jnp.asarray(A),
                                        jnp.asarray(px), half=4))
    got = N(tpatch.warp_patch(T(img), T(A), T(px), half=4))
    assert got.shape == (5, 8, 8)
    np.testing.assert_allclose(got, want, atol=ATOL_PX)
    eye = np.tile(np.eye(2, dtype=np.float32), (5, 1, 1))
    np.testing.assert_array_equal(
        N(tpatch.warp_patch(T(img), T(eye), T(px), half=4)),
        N(tinterp.extract_patches(T(img), T(px), half=4)))


def test_hamming_matrix_exact():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, size=(6, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(5, 8), dtype=np.uint32)
    want = np.asarray(jorb.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = N(torb.hamming_matrix(T(a), T(b)))
    np.testing.assert_array_equal(got, want)
    assert (np.diag(N(torb.hamming_matrix(T(a), T(a)))) == 0).all()


def test_unit_plane_to_pixel_and_frame_state():
    from sdvl_tpu.state.map_state import FrameState as JFrameState
    from sdvl_tpu_torch.state.map_state import FrameState as TFrameState

    rng = np.random.default_rng(5)
    uv = rng.normal(0, 0.5, (7, 2)).astype(np.float32)
    ij = jcam.Intrinsics.create(210.0, 209.0, 159.5, 119.5, width=320,
                                height=240)
    it = tcam.Intrinsics.create(210.0, 209.0, 159.5, 119.5, width=320,
                                height=240)
    want = np.asarray(jcam.unit_plane_to_pixel(ij, jnp.asarray(uv)))
    np.testing.assert_array_equal(N(tcam.unit_plane_to_pixel(it, T(uv))),
                                  want)
    # project -> unit plane -> pixel is the identity (no distortion)
    pts = np.concatenate([uv * 3.0, np.full((7, 1), 3.0, np.float32)], 1)
    np.testing.assert_allclose(
        N(tcam.unit_plane_to_pixel(it, tcam.project_unit_plane(T(pts)))),
        N(tcam.project(it, T(pts))), atol=1e-4)
    assert TFrameState._fields == JFrameState._fields
