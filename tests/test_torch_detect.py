"""The module that holds the port's kernel: ``ops/cuda/detect.py``.

The plain torch version of the fused FAST + Shi-Tomasi score map is held
against the TPU kernel it replaces,
``sdvl_tpu.ops.pallas.detect.fast_shi_tomasi_map(..., interpret=True)``, as
``tests/test_pallas_detect.py`` runs it on the CPU -- on the row-tiled call
(120x160) and the single-block call (64x96) -- and its per-cell result
against the reference's ``_grid_best`` on the Pallas maps of three levels.
The kernel's cell keys are checked through their torch encoding: the
unsigned maximum of the keys of a cell, decoded as the CUDA path decodes it,
must be ``_grid_best``'s winner. The ``plain`` border rule's cells are held
against the reference's plain route (``detect_level(use_pallas=False)``) per
level, invalid cells' positions and scores included. The CUDA kernel itself cannot run here (no
GPU, no nvcc); ``chip_smoke.py`` and ``tests/test_torch_cuda_kernel.py`` hold
it against the same plain version on the card.

Tolerances: the plain version keeps the Pallas kernel's float operation order,
so scores agree to rounding; rtol 1e-4 / atol 1e-2 is what the reference's own
test grants for a different summation order. The finite masks must be equal
except where a score sits within 1e-3 (relative) of the threshold.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.ops import fast as jfast
from sdvl_tpu.ops import pyramid as jpyr
from sdvl_tpu.ops.pallas.detect import fast_shi_tomasi_map as pallas_map
from sdvl_tpu_torch.ops import fast as tfast
from sdvl_tpu_torch.ops.cuda import detect
from torch_port_helpers import N, T, blocky_image

torch.set_num_threads(1)

FAST_T, ST_T = 10.0, 50.0
SHAPES = {"tiled": (120, 160), "single_block": (64, 96)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def maps(request):
    img = blocky_image(3, SHAPES[request.param])
    want = np.asarray(pallas_map(jnp.asarray(img), FAST_T, ST_T,
                                 interpret=True))
    got = N(detect.fast_shi_tomasi_map_plain(T(img), FAST_T, ST_T))
    return img, got, want


def test_plain_matches_pallas_scores(maps):
    _, got, want = maps
    assert got.shape == want.shape and got.dtype == np.float32
    both = np.isfinite(got) & np.isfinite(want)
    assert both.sum() > 50
    np.testing.assert_allclose(got[both], want[both], rtol=1e-4, atol=1e-2)


def test_plain_matches_pallas_mask_full_map(maps):
    """Full-map equality of the finite mask (border included: both write
    -inf there), away from the score threshold."""
    _, got, want = maps
    diff = np.isfinite(got) != np.isfinite(want)
    v = np.where(np.isfinite(got), got, want)[diff]
    assert (np.abs(v - ST_T) <= 1e-3 * ST_T).all(), v
    assert diff.mean() < 1e-3


def test_border_is_invalid(maps):
    _, got, _ = maps
    B = 4
    inner = np.zeros(got.shape, bool)
    inner[B:-B, B:-B] = True
    assert not np.isfinite(got[~inner]).any()
    assert not np.isnan(got).any()


def test_grid_selection_equivalent(maps):
    """Per-cell winners from the plain map equal the winners from the
    Pallas map (same cells valid, same pixel, same score)."""
    img, got, want = maps
    xy_t, best_t, valid_t = tfast._grid_best(T(got), torch.isfinite(T(got)), 32)
    xy_j, best_j, valid_j = jfast._grid_best(
        jnp.asarray(want), jnp.isfinite(jnp.asarray(want)), 32)
    np.testing.assert_array_equal(N(valid_t), np.asarray(valid_j))
    v = N(valid_t)
    assert v.sum() >= 4
    np.testing.assert_array_equal(N(xy_t)[v], np.asarray(xy_j)[v])
    np.testing.assert_allclose(N(best_t)[v], np.asarray(best_j)[v],
                               rtol=1e-4, atol=1e-2)


def test_plain_matches_plain_route_interior():
    """Inside the 4-px border the fused contract equals the plain route
    (FAST mask AND score threshold on the Shi-Tomasi map) of the port."""
    img = T(blocky_image(5))
    fused = N(detect.fast_shi_tomasi_map_plain(img, FAST_T, ST_T))
    corner = N(tfast.fast_corner_mask(img, FAST_T))
    score = N(tfast.shi_tomasi(img))
    want = np.where(corner & (score > ST_T), score, -np.inf)
    B = 4
    g, w = fused[B:-B, B:-B], want[B:-B, B:-B]
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    both = np.isfinite(g)
    np.testing.assert_allclose(g[both], w[both], rtol=1e-5)


@pytest.mark.parametrize("border", detect.BORDERS)
def test_wrapper_takes_plain_version_on_cpu_only(border):
    """On CPU tensors the wrappers run the plain versions and count no
    launch; the CUDA branch has no fallback (it builds and launches or
    raises), which this machine can only check by reading the dispatch."""
    img = T(blocky_image(6, (64, 96)))
    before = detect.launches()
    out = detect.fast_shi_tomasi_map(img, FAST_T, ST_T)
    cells = detect.fast_shi_tomasi_cells([img, img[::2, ::2].contiguous()],
                                         16, FAST_T, ST_T, border)
    assert detect.launches() == before
    torch.testing.assert_close(
        out, detect.fast_shi_tomasi_map_plain(img, FAST_T, ST_T),
        rtol=0, atol=0)
    want = detect.fast_shi_tomasi_cells_plain(
        [img, img[::2, ::2].contiguous()], 16, FAST_T, ST_T, border)
    for a, b in zip(cells[1:], want[1:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="border"):
        detect.fast_shi_tomasi_cells([img], 16, border="edge")
    import inspect

    src = "".join(inspect.getsource(f) for f in (
        detect.fast_shi_tomasi_map, detect.fast_shi_tomasi_cells,
        detect._launch, detect._cells_from_keys))
    assert "try" not in src and "except" not in src


def test_kernel_source_is_in_the_package():
    import os

    assert os.path.isfile(detect.SOURCE)
    text = open(detect.SOURCE).read()
    assert 'extern "C" int sdvl_detect_levels' in text
    assert text.count("__global__") == 1 and "cp.async.cg.shared.global" in text
    assert "__global__" in text and "__shared__" in text
    assert "compute_90a" in " ".join(detect.NVCC_FLAGS)


# ---------------------------------------------------------------- cells
def _jax_cells(levels, cell):
    """The reference's fused route per level: Pallas map (interpret mode),
    ``_grid_best``, the score threshold, level-0 scale."""
    xy, score, valid = [], [], []
    for l, lev in enumerate(levels):
        smap = pallas_map(jnp.asarray(lev), FAST_T, ST_T, interpret=True)
        p, best, ok = jfast._grid_best(smap, jnp.isfinite(smap), cell)
        xy.append(np.asarray(p) * float(1 << l))
        score.append(np.asarray(best))
        valid.append(np.asarray(ok & (best > ST_T)))
    return np.concatenate(xy), np.concatenate(score), np.concatenate(valid)


@pytest.fixture(scope="module")
def three_levels():
    """The first three levels of the reference's pyramid of a 120x160
    image, as numpy arrays fed to both sides."""
    img = blocky_image(8, (120, 160))
    return [np.asarray(p) for p in jpyr.build_pyramid(jnp.asarray(img), 3)]


@pytest.mark.parametrize("cell", [16, 32])
def test_plain_cells_match_pallas_grid_best(three_levels, cell):
    """Plain cell result of all levels against ``_grid_best`` on the Pallas
    maps. At cell 32 the 30x40 level has no cell row, so no slot."""
    xy_j, score_j, valid_j = _jax_cells(three_levels, cell)
    maps, xy, score, valid, level = detect.fast_shi_tomasi_cells(
        [T(l) for l in three_levels], cell, FAST_T, ST_T, border="pallas")
    counts = [(h // cell) * (w // cell) for h, w in
              (l.shape for l in three_levels)]
    assert xy.shape == (sum(counts), 2) and score.shape == valid.shape
    if cell == 32:
        assert counts[2] == 0
    np.testing.assert_array_equal(
        N(level), np.repeat(np.arange(3), counts).astype(np.int32))
    assert [tuple(m.shape) for m in maps] == [l.shape for l in three_levels]
    v = N(valid)
    np.testing.assert_array_equal(v, valid_j)
    assert v.sum() >= 4
    np.testing.assert_array_equal(N(xy)[v], xy_j[v])
    np.testing.assert_allclose(N(score), score_j, rtol=1e-4, atol=1e-2)


def _tie_map():
    """24x44 map, cell 8 (a 3 x 5 grid; columns 40-43 are the remnant):
    cell 0 has the score 70 at in-cell indices 11 and 42 (and 60 at 0 and
    63), cell 1 is all -inf, cell 2 holds -0.0 (index 17) and +0.0 (index
    24) only, cells 3, 4 and 10 one finite pixel each; the remnant holds a
    higher score that must not count."""
    m = np.full((24, 44), -np.inf, np.float32)
    m[1, 3] = m[5, 2] = 70.0
    m[0, 0] = m[7, 7] = 60.0
    m[2, 17] = -0.0
    m[3, 16] = 0.0
    m[4, 25] = 55.0
    m[1, 36] = 80.0
    m[0, 41] = 99.0
    m[23, 0] = 65.0
    return m


def _emulated_kernel_keys(smap: np.ndarray, cell: int) -> torch.Tensor:
    """The kernel's key buffer in numpy: the unsigned max of the pixels'
    keys per cell of the cropped grid."""
    H, W = smap.shape
    gh, gw = H // cell, W // cell
    yy, xx = np.mgrid[: gh * cell, : gw * cell]
    idx = (yy % cell) * cell + xx % cell
    keys = N(detect.encode_keys(T(smap[: gh * cell, : gw * cell]),
                                T(idx))).view(np.uint64)
    out = np.zeros(gh * gw, np.uint64)
    np.maximum.at(out, ((yy // cell) * gw + xx // cell).ravel(), keys.ravel())
    return torch.from_numpy(out.view(np.int64))


def test_cell_ties_and_empty_cells():
    """Equal maxima: the first in-cell index wins; an all -inf cell gives
    index 0 and is invalid; -0.0 ties +0.0 (first index). Both the plain
    rule and the kernel's key maximum, decoded as the CUDA path decodes it,
    give the same slots."""
    smap = _tie_map()
    cell = 8
    xy, best, valid = detect.grid_best(T(smap), torch.isfinite(T(smap)), cell)
    assert N(xy)[0].tolist() == [3.0, 1.0]       # index 11, not 42
    assert N(xy)[1].tolist() == [8.0, 0.0] and not bool(valid[1])
    assert N(xy)[2].tolist() == [17.0, 2.0]      # -0.0 at index 17 first
    assert N(xy)[4].tolist() == [36.0, 1.0]      # 80, not the remnant's 99
    assert N(valid).sum() == 5
    keys = _emulated_kernel_keys(smap, cell)
    kxy, kscore, kvalid, klevel = detect._cells_from_keys(
        keys, ((24, 44),), cell, -1.0)
    np.testing.assert_array_equal(N(kxy), N(xy))
    np.testing.assert_array_equal(N(kvalid), N(valid))
    np.testing.assert_array_equal(N(kscore), N(best))
    assert (N(klevel) == 0).all()


def test_key_encoding_round_trip_and_order():
    rng = np.random.default_rng(9)
    s = np.concatenate([rng.normal(0, 1e3, 200), [0.0, -0.0, np.inf,
                        -np.inf, 1e-40, -1e-40, 3.4e38, -3.4e38]]
                       ).astype(np.float32)
    idx = rng.integers(0, 1 << 30, s.size)
    keys = detect.encode_keys(T(s), T(idx))
    got_s, got_i = detect.decode_keys(keys)
    np.testing.assert_array_equal(N(got_i), idx)
    want = np.where(s == 0, np.float32(0.0), s)     # -0.0 decodes as +0.0
    np.testing.assert_array_equal(N(got_s).view(np.uint32),
                                  want.view(np.uint32))
    # unsigned key order = (score, then smaller index) order
    u = N(keys).view(np.uint64)
    order = np.argsort(u, kind="stable")
    ss, ii = s[order].astype(np.float64), idx[order]
    assert (np.diff(ss) >= 0).all()
    same = np.diff(ss) == 0
    assert (np.diff(ii)[same] <= 0).all()
    # -0.0 and +0.0 tie: the key of the smaller index is larger
    k = N(detect.encode_keys(T(np.float32([-0.0, 0.0])), T([5, 6]))
          ).view(np.uint64)
    assert k[0] > k[1]
    # every real key is above the zeroed buffer
    assert (u > 0).all()


@pytest.mark.parametrize("border", detect.BORDERS)
def test_kernel_keys_decode_to_plain_cells(three_levels, border):
    """The CUDA path's decode on emulated kernel keys of the plain maps
    equals the plain cell result of all levels, bit for bit, under both
    border rules (under ``plain``, with a threshold that leaves some FAST
    corners below it, invalid cells carry their best corner's score)."""
    cell = 16
    st = ST_T if border == "pallas" else 3000.0
    levels = [T(l) for l in three_levels]
    maps, xy, score, valid, level = detect.fast_shi_tomasi_cells_plain(
        levels, cell, FAST_T, st, border)
    keys = torch.cat([_emulated_kernel_keys(N(m), cell) for m in maps])
    shapes = tuple(tuple(m.shape) for m in maps)
    kxy, kscore, kvalid, klevel = detect._cells_from_keys(
        keys, shapes, cell, st)
    assert int(valid.sum()) >= 4
    if border == "plain":
        assert bool(((score != 0) & ~valid).any())
    for a, b in ((kxy, xy), (kscore, score), (kvalid, valid),
                 (klevel, level)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------- the plain border rule
PLAIN_CASES = [((128, 160), 16), ((123, 171), 16), ((64, 96), 16)]


@functools.lru_cache(maxsize=None)
def _jax_plain_level(cell):
    """The reference's plain route on one level, jitted: its cells
    (``detect_level(use_pallas=False)`` at level 0: unscaled positions)
    and the score map ``where(fast_corner_mask, shi_tomasi, -inf)``."""
    def level(img):
        c = jfast.detect_level(img, 0, cell=cell, fast_threshold=FAST_T,
                               st_threshold=ST_T)
        smap = jnp.where(jfast.fast_corner_mask(img, FAST_T),
                         jfast.shi_tomasi(img), -jnp.inf)
        return c.xy, c.score, c.valid, smap

    return jax.jit(level)


@pytest.mark.parametrize("shape,cell", PLAIN_CASES,
                         ids=[f"{h}x{w}-c{c}" for (h, w), c in PLAIN_CASES])
def test_plain_border_cells_match_reference_plain_route(shape, cell):
    """``border="plain"``: per level, every cell's position, score and
    validity equal the reference's plain route
    (``detect_level(use_pallas=False)``: FAST on edge-replicated pixels,
    Shi-Tomasi with wrapped Sobel and zero-padded box sums, the best FAST
    corner per cell whatever its score, then the threshold) -- invalid cells
    included, which keep their best sub-threshold corner. The score maps
    equal the reference's ``where(fast_corner_mask, shi_tomasi, -inf)``.
    Scores to float32 rounding (rtol 1e-5: XLA and torch may order the
    same float32 sums differently); positions and flags exactly."""
    img = blocky_image(11, shape)
    # corners at the image edge, where the two border rules part
    img[:3, 10:14] = 250.0
    img[-2:, -12:-9] = 0.0
    img[20:23, :2] = 240.0
    pj = jpyr.build_pyramid(jnp.asarray(img), 3)
    levels = [np.asarray(p) for p in pj]
    maps, xy, score, valid, level = detect.fast_shi_tomasi_cells(
        [T(l) for l in levels], cell, FAST_T, ST_T, border="plain")
    off = 0
    n_edge = 0
    for l, lev in enumerate(levels):
        jxy, jscore, jvalid, want = (np.asarray(a) for a in
                                     _jax_plain_level(cell)(lev))
        n = jxy.shape[0]
        sl = slice(off, off + n)
        off += n
        np.testing.assert_array_equal(N(xy[sl]), jxy * float(1 << l))
        np.testing.assert_array_equal(N(valid[sl]), jvalid)
        np.testing.assert_allclose(N(score[sl]), jscore, rtol=1e-5,
                                   atol=1e-4)
        assert (N(level[sl]) == l).all()
        got = N(maps[l])
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        f = np.isfinite(got)
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-4)
        B = 4
        edge = np.ones(got.shape, bool)
        edge[B:-B, B:-B] = False
        n_edge += int(np.isfinite(got[edge]).sum())
    assert off == xy.shape[0]
    assert int(valid.sum()) >= 4
    assert n_edge > 0          # the rule was exercised at the border


def test_plain_and_pallas_rules_part_at_the_border_only():
    """The two rules' maps agree on which interior pixels are corners above
    the threshold; the plain rule also scores the 4-px border."""
    img = T(blocky_image(12, (64, 96)))
    img[:2, 30:34] = 250.0
    plain = N(detect.plain_route_map(img, FAST_T))
    pallas = N(detect.fast_shi_tomasi_map_plain(img, FAST_T, ST_T))
    B = 4
    inner = (slice(B, -B), slice(B, -B))
    np.testing.assert_array_equal((plain > ST_T)[inner],
                                  np.isfinite(pallas)[inner])
    assert np.isfinite(plain[:B]).any()
    assert not np.isfinite(pallas[:B]).any()
