"""The port's point-sharded bundle adjustment (``dist/ba_sharded.py``,
``pipeline/mapper.global_ba(mesh=...)``) against the JAX package's and
against the port's own one-process solve.

The JAX side runs ``sdvl_tpu.dist.ba_sharded.solve_sharded`` on the
conftest's 8-device CPU mesh, as ``tests/test_dist.py`` does; the port runs
in this process as a gloo group of one rank (a ``file://`` rendezvous in a
temporary directory), so its collectives run and sum one shard. The
cross-rank sums are held in ``tests/test_torch_multihost.py`` (2 gloo
processes). Both packages solve the same numbers: the JAX problem of
``sdvl_tpu.dist.multihost.demo_ba_problem`` handed over as numpy arrays.

Tolerances (``tests/test_dist.py``'s): poses 5e-4, points 5e-3, chi2 within
1e-3 relative -- ``psum`` and the one-process sum add the shards in other
orders; global BA's sharded write-back against the one-process one at
``tests/test_global_ba.py``'s (poses 2e-4, points 2e-3).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sdvl_tpu.dist import ba_sharded as jsharded
from sdvl_tpu.dist import mesh as jmesh
from sdvl_tpu.dist import multihost as jmultihost
from sdvl_tpu_torch.core.camera import Intrinsics
from sdvl_tpu_torch.dist import ba_sharded, mesh as tmesh
from sdvl_tpu_torch.io.snapshot import map_from_numpy
from sdvl_tpu_torch.pipeline import mapper as tmapper
from sdvl_tpu_torch.solvers import ba
from torch_port_helpers import N, T, tree_to_numpy

torch.set_num_threads(1)

HUBER = float(np.sqrt(5.991) / 420.0)


@pytest.fixture(scope="module")
def point_mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield tmesh.make_mesh(axis="point")
    finally:
        dist.destroy_process_group()


def _problems(seed=11):
    pj = jmultihost.demo_ba_problem(seed=seed)
    pt = ba.BAProblem(*(T(x) for x in pj))
    return pj, pt


def _close(a, b, chi_a, chi_b):
    np.testing.assert_allclose(N(a.poses), np.asarray(b.poses), atol=5e-4)
    np.testing.assert_allclose(N(a.points), np.asarray(b.points), atol=5e-3)
    assert abs(float(chi_a) - float(chi_b)) < 1e-3 * max(float(chi_b), 1.0)


@pytest.mark.parametrize("method", ["chol", "cg"])
def test_sharded_matches_jax_and_one_process(point_mesh, method):
    pj, pt = _problems()
    rj = jsharded.solve_sharded(pj, jmesh.make_mesh(), huber=HUBER,
                                method=method)
    rs = ba_sharded.solve_sharded(pt, point_mesh, huber=HUBER, method=method)
    r1 = ba.solve(pt, huber=HUBER, method=method)
    assert (rs.cg_iterations.numel() > 0) == (method == "cg")
    _close(rs, rj, rs.chi2, rj.chi2)
    _close(rs, r1, rs.chi2, r1.chi2)
    np.testing.assert_array_equal(N(rs.inlier_mask), np.asarray(rj.inlier_mask))
    assert rs.points.shape == pt.points.shape


def test_sharded_cg_matches_dense(point_mesh):
    _, pt = _problems(seed=14)
    chol = ba_sharded.solve_sharded(pt, point_mesh, huber=HUBER,
                                    method="chol")
    cg = ba_sharded.solve_sharded(pt, point_mesh, huber=HUBER, method="cg")
    np.testing.assert_allclose(N(cg.poses), N(chol.poses), atol=5e-4)
    np.testing.assert_allclose(N(cg.points), N(chol.points), atol=5e-3)
    assert abs(float(cg.chi2) - float(chol.chi2)) < 1e-3 * max(
        float(chol.chi2), 1.0)


def test_sharded_rows_must_divide(point_mesh):
    assert tmesh.shard_rows(256, point_mesh, "point") == slice(0, 256)
    assert tmesh.axis_size(None, "point") == 1
    assert tmesh.axis_group(None, "point") is None
    with pytest.raises(ValueError, match="method"):
        ba.solve(_problems()[1], huber=HUBER, method="lu")


def test_global_ba_sharded_matches_one_process(point_mesh):
    """``tests/test_global_ba.py``'s perturbed ground-truth map (6
    keyframes, 256 points), refined with the points sharded, against the
    port's one-process ``global_ba`` (held against the JAX package's in
    ``tests/test_torch_global_ba.py``), as
    ``tests/test_global_ba.py::test_global_ba_sharded_matches_single_device``
    holds the JAX package's sharded write-back against its own; and the map
    snaps back to the ground truth (that test's criteria)."""
    from test_global_ba import H, W, _gt_map, _perturb

    intr, m_gt, poses_gt, pts_gt = _gt_map(seed=2)
    m0 = _perturb(m_gt, seed=3)
    intr_t = Intrinsics.create(90.0, 90.0, W / 2 - 0.5, H / 2 - 0.5,
                               width=W, height=H)
    mt0 = map_from_numpy(tree_to_numpy(m0), "cpu")
    ms = tmapper.global_ba(mt0, intr_t, mesh=point_mesh, stage_iters=(6, 6))
    m1 = tmapper.global_ba(mt0, intr_t, stage_iters=(6, 6))
    np.testing.assert_allclose(N(ms.kf_pose), N(m1.kf_pose), atol=2e-4)
    np.testing.assert_allclose(N(ms.pt_pos), N(m1.pt_pos), atol=2e-3)
    np.testing.assert_array_equal(N(ms.obs_mask), N(m1.obs_mask))
    assert np.abs(N(ms.kf_pose)[2:, 4:] - np.asarray(poses_gt)[2:, 4:]).max() \
        < 1e-3


def test_global_ba_over_gloo_refuses_graphs_and_runs_eagerly(point_mesh):
    """gloo collectives cannot be captured in a CUDA graph: ``graphs=True``
    over a gloo mesh raises, naming gloo, before any work; by default the
    gloo mesh runs eagerly, bit for bit as ``graphs=False``."""
    from test_global_ba import H, W, _gt_map, _perturb

    _, m_gt, _, _ = _gt_map(seed=2)
    intr_t = Intrinsics.create(90.0, 90.0, W / 2 - 0.5, H / 2 - 0.5,
                               width=W, height=H)
    mt0 = map_from_numpy(tree_to_numpy(_perturb(m_gt, seed=3)), "cpu")
    with pytest.raises(ValueError, match="gloo"):
        tmapper.global_ba(mt0, intr_t, mesh=point_mesh, graphs=True)
    stats = {}
    default = tmapper.global_ba(mt0, intr_t, mesh=point_mesh,
                                stage_iters=(6, 6), stats=stats)
    eager = tmapper.global_ba(mt0, intr_t, mesh=point_mesh, graphs=False,
                              stage_iters=(6, 6))
    assert "replays" not in stats
    for a, b in zip((default.kf_pose, default.pt_pos, default.obs_mask),
                    (eager.kf_pose, eager.pt_pos, eager.obs_mask)):
        assert torch.equal(a, b)
