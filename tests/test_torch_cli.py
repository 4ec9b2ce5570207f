"""The port's command-line program (``python -m sdvl_tpu_torch.cli.run``),
its dataset readers, the native loader binding and the tracer.

The CLI runs in process on the CPU (``--device cpu``) over 320x240
``PlaneScene`` frames written as binary PGM files with a ``files.txt`` and a
small ``.cfg``: the stream driver with global BA (its trajectory file held
to 1e-6 against the same run made through the library), the host driver
with tracing and a snapshot, a resumed session, localization against the
stream's snapshot, chunked feeding, the refused flags and one short
``--synthetic`` run.
The readers are held against the JAX package's on tiny text fixtures
(equal), the decoders against OpenCV (equal; JPEG within a mean of 6 grey
levels, as in ``tests/test_native_loader.py``), ``save_tum_trajectory``
against the reference's within 1e-6.
"""

import contextlib
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from sdvl_tpu.cli import run as jrun
from sdvl_tpu.io import dataset as jds
from sdvl_tpu_torch.cli import run as trun
from sdvl_tpu_torch.core import se3
from sdvl_tpu_torch.io import dataset as tds
from sdvl_tpu_torch.io import evaluate, native_loader
from sdvl_tpu_torch.io.synthetic import PlaneScene
from sdvl_tpu_torch.pipeline import mapper
from sdvl_tpu_torch.pipeline.config import intrinsics, load_cfg
from sdvl_tpu_torch.pipeline.stream import SdvlStream
from sdvl_tpu_torch.utils.trace import Tracer

torch.set_num_threads(1)

N_FRAMES = 30
CFG = """%YAML:1.0
Camera.width: 320
Camera.height: 240
Camera.fx: 210.0
Camera.fy: 210.0
Camera.u0: 159.5
Camera.v0: 119.5
SDVL.cell_size: 32
SDVL.min_avg_shift: 5
SDVL.max_keyframes: 10
SDVL.min_keyframe_its: 5
SDVL.min_init_corners: 30
SDVL.max_points: 512
SDVL.max_candidates: 256
SDVL.min_matches: 15
SDVL.map_scale: 4.0
"""


def write_pgm(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n# frame\n%d %d\n255\n" % (w, h) + img.tobytes())


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """PGM frames, ``files.txt``, ``query.txt`` (frames 8-29) and the
    config, in one directory."""
    return write_seq(tmp_path_factory.mktemp("seq"))


def write_seq(d):
    """:func:`seq`'s files written into the directory ``d`` (a Path)."""
    scene = PlaneScene(fx=210.0, fy=210.0, cx=159.5, cy=119.5, width=320,
                       height=240, plane_z=4.0)
    poses = np.stack(scene.trajectory(N_FRAMES))
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in poses]
    names = [f"f{i:03d}.pgm" for i in range(N_FRAMES)]
    for n, img in zip(names, frames):
        write_pgm(str(d / n), img)
    (d / "files.txt").write_text("\n".join(names) + "\n")
    (d / "query.txt").write_text("\n".join(names[8:]) + "\n")
    (d / "small.cfg").write_text(CFG)
    return dict(dir=str(d), cfg=str(d / "small.cfg"), frames=frames,
                poses=poses)


def run_cli(capsys, *argv):
    """``main(argv)`` on the CPU; returns (stdout lines, summary dict)."""
    assert trun.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    summary = [json.loads(ln) for ln in out if ln.startswith("{")]
    assert len(summary) == 1, out
    return out, summary[0]


def frame_states(lines):
    """State per frame from the CLI's per-frame log lines."""
    return [ln.split()[3] for ln in lines if ln.startswith("[INFO] frame ")]


@pytest.fixture(scope="module")
def stream_run(seq, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    paths = dict(out=str(tmp / "traj.txt"), snap=str(tmp / "snap.npz"),
                 trace=str(tmp / "trace.json"))
    buf = io.StringIO()     # (capsys is function-scoped)
    with contextlib.redirect_stdout(buf):
        rc = trun.main(["--device", "cpu", "--config", seq["cfg"],
                        "--images", seq["dir"], "--stream", "--global-ba",
                        "--output", paths["out"], "--snapshot",
                        paths["snap"], "--trace", paths["trace"], "--quiet"])
    assert rc == 0
    return paths, buf.getvalue().splitlines()


def test_stream_global_ba_output(seq, stream_run):
    paths, lines = stream_run
    summary = json.loads(next(ln for ln in lines if ln.startswith("{")))
    assert set(summary) == {"frames", "keyframes", "points", "mean_ms",
                            "fps", "wall_s"}
    assert summary["frames"] == N_FRAMES and summary["keyframes"] >= 2
    assert any(ln.startswith("[INFO] global BA over ") for ln in lines)
    assert f"[INFO] trajectory written to {paths['out']}" in lines

    # the same run through the library: stream, global BA, rebase
    cfg = load_cfg(seq["cfg"])
    st = SdvlStream(cfg, device="cpu")
    for f in seq["frames"]:
        st.feed(f)
    r = st.result()
    m = st.m
    m_new = mapper.global_ba(m, intrinsics(cfg))
    traj = evaluate.rebase_trajectory(
        r.trajectory, np.arange(r.n_frames), m.kf_frame_id.numpy(),
        m.kf_pose.numpy(), m_new.kf_pose.numpy(), m.kf_valid.numpy())
    rows = np.loadtxt(paths["out"])
    assert rows.shape == (N_FRAMES, 8) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], np.arange(N_FRAMES) / 30.0)
    centres = se3.translation(se3.inverse(torch.from_numpy(traj))).numpy()
    np.testing.assert_allclose(rows[:, 1:4], centres, atol=1e-6)
    # global BA moved the keyframes, and the run tracks the ground truth
    assert not np.array_equal(traj, r.trajectory)
    start = int(np.argmax(r.states == 2))
    p_gt = evaluate.positions_from_poses(seq["poses"][start:])
    extent = float(np.linalg.norm(np.ptp(p_gt, axis=0)))
    ate = evaluate.ate_rmse(rows[start:, 1:4], p_gt, with_scale=True)
    assert ate < 0.03 * extent, (ate, extent)


def test_stream_trace_holds_the_global_ba_span(stream_run):
    """``--trace`` on the stream driver: the end-of-run global BA is one
    span (eager on the CPU: no graph spans, no stage marks), and the JSON
    holds the kernels' build counters, and tracing is off after the run."""
    from sdvl_tpu_torch.utils import trace

    paths, lines = stream_run
    tj = json.loads(open(paths["trace"]).read())
    assert set(tj) == {"spans", "stages", "counters"}
    assert tj["spans"]["global_ba"]["n"] == 1
    assert not any(n.startswith("graph.") for n in tj["spans"])
    assert tj["stages"] == {}
    assert f"[INFO] trace summary written to {paths['trace']}" in lines
    assert not trace.tracer().enabled


def test_host_trace_snapshot_then_resume(seq, capsys, tmp_path):
    trace, snap = str(tmp_path / "trace.json"), str(tmp_path / "s.npz")
    lines, summary = run_cli(capsys, "--config", seq["cfg"], "--images",
                             seq["dir"], "--trace", trace, "--snapshot",
                             snap)
    assert set(summary) == {"frames", "keyframes", "points", "mean_ms",
                            "fps"}
    states = frame_states(lines)
    assert len(states) == N_FRAMES and states[-1] == "RUNNING"
    tj = json.loads(open(trace).read())
    spans = tj["spans"]
    assert "preprocess" in spans and "track" in spans
    assert "map_update" in spans
    assert spans["preprocess"]["n"] == N_FRAMES
    assert set(tj) == {"spans", "stages", "counters"}
    lines, summary = run_cli(capsys, "--config", seq["cfg"], "--images",
                             seq["dir"], "--resume", snap, "--max-frames",
                             "6", "--quiet")
    assert f"[INFO] resumed from {snap} at frame {N_FRAMES}" in lines
    assert summary["frames"] == 6


def test_localize_against_the_stream_snapshot(seq, stream_run, capsys):
    paths, _ = stream_run
    lines, summary = run_cli(capsys, "--config", seq["cfg"], "--images",
                             seq["dir"], "--filename", "query.txt",
                             "--stream", "--localize", paths["snap"])
    assert any("localization-only session" in ln for ln in lines)
    states = frame_states(lines)
    assert len(states) == N_FRAMES - 8 == summary["frames"]
    assert "RUNNING" in states[:5] and set(states[-5:]) == {"RUNNING"}


def test_stream_chunks_match_single_frames(seq, capsys, tmp_path):
    """``--chunk 7 --max-frames 20`` (three chunks, the last one cut to the
    limit) gives the trajectory of frame-by-frame feeding."""
    rows = []
    for extra in ([], ["--chunk", "7"]):
        out = str(tmp_path / f"t{len(extra)}.txt")
        _, summary = run_cli(capsys, "--config", seq["cfg"], "--images",
                             seq["dir"], "--stream", "--max-frames", "20",
                             "--output", out, "--quiet", *extra)
        assert summary["frames"] == 20
        rows.append(np.loadtxt(out))
    np.testing.assert_array_equal(rows[1], rows[0])


@pytest.mark.parametrize("flag", [["--viz", "out"], ["--live"]])
def test_unported_flags_are_refused(seq, capsys, flag, monkeypatch,
                                    tmp_path):
    """What the viewer flags refuse, now that both are ported: ``--viz`` on
    a machine without matplotlib stops before the first frame with an error
    naming it; ``--live`` without a display refuses the windows with a
    warning and runs headless, as ``sdvl_tpu.cli.run`` does."""
    if flag[0] == "--viz":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(RuntimeError, match="matplotlib"):
            trun.main(["--device", "cpu", "--config", seq["cfg"], "--images",
                       seq["dir"], "--viz", str(tmp_path / "out")])
        assert "[INFO] frame" not in capsys.readouterr().out
        assert not (tmp_path / "out").exists()
        return
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    lines, summary = run_cli(capsys, "--config", seq["cfg"], "--images",
                             seq["dir"], "--live", "--max-frames", "3")
    assert summary["frames"] == 3
    assert any(ln.startswith("[WARN] --live: no display") for ln in lines)


def test_cuda_default_without_a_card_raises(seq):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--config", seq["cfg"], "--images", seq["dir"]])


def test_synthetic_short_run(capsys):
    _, summary = run_cli(capsys, "--synthetic", "3", "--quiet")
    assert summary["frames"] == 3


# ------------------------------------------------------------ readers


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Tiny TUM and EuRoC sequences (text only)."""
    d = tmp_path_factory.mktemp("ds")
    tum = d / "tum"
    tum.mkdir()
    (tum / "rgb.txt").write_text(
        "# color images\n# file\n# timestamp filename\n"
        "1305031102.175304 rgb/1305031102.175304.png\n"
        "1305031102.211214 rgb/1305031102.211214.png\n"
        "bad\n"
        "1305031102.243211 rgb/1305031102.243211.png\n")
    (tum / "groundtruth.txt").write_text(
        "# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n"
        "1305031098.6659 1.3563 0.6305 1.6380 0.6132 0.5962 -0.3311 -0.3986\n"
        "1305031098.6758 1.3543 0.6306 1.6360 0.6129 0.5966 -0.3316 -0.3980\n"
        "1305031098.6858 1.3524 0.6306 1.6340 0.6126 0.5972 -0.3319 -0.3973\n")
    euroc = d / "euroc" / "mav0"
    (euroc / "cam0" / "data").mkdir(parents=True)
    (euroc / "state_groundtruth_estimate0").mkdir()
    (euroc / "cam0" / "data.csv").write_text(
        "#timestamp [ns],filename\n"
        "1403636579763555584,1403636579763555584.png\n"
        "1403636579813555456,1403636579813555456.png\n\n")
    (euroc / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], "
        "q_RS_x [], q_RS_y [], q_RS_z []\n"
        "1403636580838555648,4.688319,-1.786938,0.783338,0.534108,"
        "-0.153029,-0.827383,-0.082152\n"
        "1403636580843555328,4.688177,-1.786770,0.787350,0.534640,"
        "-0.152990,-0.826976,-0.082863\n")
    return str(tum), str(d / "euroc")


def test_tum_and_euroc_readers_match_reference(datasets):
    tum, euroc = datasets
    assert tds.tum_rgb_index(tum) == jds.tum_rgb_index(tum)
    np.testing.assert_array_equal(tds.load_tum_groundtruth(tum),
                                  jds.load_tum_groundtruth(tum))
    for root in (euroc, os.path.join(euroc, "mav0")):
        assert tds.euroc_index(root) == jds.euroc_index(root)
        np.testing.assert_array_equal(tds.load_euroc_groundtruth(root),
                                      jds.load_euroc_groundtruth(root))
    assert len(tds.tum_rgb_index(tum)[0]) == 3


def test_save_tum_trajectory_matches_reference(tmp_path):
    rs = np.random.default_rng(0)
    xi = rs.normal(0, 0.3, (7, 6)).astype(np.float32)
    poses = se3.exp(torch.from_numpy(xi)).numpy()
    stamps = list(np.arange(7) * 0.05 + 17.0)
    tds.save_tum_trajectory(str(tmp_path / "t.txt"), stamps, poses)
    jds.save_tum_trajectory(str(tmp_path / "j.txt"), stamps, poses)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.txt"),
                               np.loadtxt(tmp_path / "j.txt"), atol=1e-6)


def test_ate_helpers_match_reference():
    """``_ate_vs_seq_gt`` (timestamp association, TUM rows) and
    ``_ate_vs_gt`` against the reference CLI's helpers."""
    rs = np.random.default_rng(1)
    xi = np.cumsum(rs.normal(0, 0.05, (40, 6)), 0).astype(np.float32)
    gt_wc = se3.exp(torch.from_numpy(xi)).numpy()
    est = se3.exp(torch.from_numpy(
        xi + rs.normal(0, 0.01, xi.shape).astype(np.float32))).numpy()
    cw = se3.inverse(torch.from_numpy(gt_wc)).numpy()
    stamps = np.arange(40) * 0.033 + 100.0
    gt_rows = np.concatenate([stamps[:, None] + 0.001, cw[:, 4:],
                              cw[:, 1:4], cw[:, :1]], axis=1)
    tracked = np.ones(40, bool)
    tracked[:3] = False
    a = trun._ate_vs_seq_gt(gt_rows, stamps, est, tracked)
    b = jrun._ate_vs_seq_gt(gt_rows, stamps, est, tracked)
    assert set(a) == set(b) == {"ate_rmse_gt", "rpe_gt", "rpe_rot_deg_gt"}
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=2e-4), k
    a, b = trun._ate_vs_gt(est, gt_wc, tracked), jrun._ate_vs_gt(est, gt_wc,
                                                                tracked)
    assert set(a) == set(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=2e-4), k


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rs = np.random.default_rng(0)
    out = []
    for i in range(9):
        img = rs.integers(0, 255, (48, 64), dtype=np.uint8)
        ext = ["png", "jpg", "pgm"][i % 3]
        p = str(d / f"frame_{i:03d}.{ext}")
        cv2.imwrite(p, img)
        out.append((p, img))
    return out


def test_native_loader_decodes_all_formats(images):
    assert native_loader.ensure_built(), native_loader.build_error()
    # built into the port's _build/, never into the repository's native/
    pkg = os.path.dirname(os.path.dirname(native_loader.__file__))
    assert native_loader.LIB_PATH == os.path.join(pkg, "_build",
                                                  "libsdvl_native.so")
    frames = list(native_loader.frame_source([p for p, _ in images], 64, 48))
    assert len(frames) == len(images)
    for (p, orig), got in zip(images, frames):
        want = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        if p.endswith(".jpg"):
            assert np.abs(got - orig.astype(np.float32)).mean() < 6.0, p
        else:
            np.testing.assert_array_equal(got, want, err_msg=p)
        # the reader of single images: same pixels, uint8
        np.testing.assert_array_equal(tds._imread_gray(p),
                                      cv2.imread(p, cv2.IMREAD_GRAYSCALE))


def test_pgm_without_the_native_loader(images, tmp_path):
    pgm = [p for p, _ in images if p.endswith(".pgm")]
    native = list(native_loader.frame_source(pgm, 64, 48))
    plain = list(native_loader.frame_source(pgm, 64, 48, prefer_native=False,
                                            indexed=True))
    assert [i for i, _ in plain] == list(range(len(pgm)))
    for a, (_, b) in zip(native, plain):
        np.testing.assert_array_equal(a, b)
    # 16-bit samples scale as the native decoder scales them
    img16 = np.arange(48 * 64, dtype=">u2").reshape(48, 64) * 7
    p16 = str(tmp_path / "deep.pgm")
    with open(p16, "wb") as f:
        f.write(b"P5 64 48 65535\n" + img16.tobytes())
    np.testing.assert_array_equal(
        next(native_loader.frame_source([p16], 64, 48, prefer_native=False)),
        next(native_loader.frame_source([p16], 64, 48)))
    png = [p for p, _ in images if p.endswith(".png")]
    with pytest.raises(RuntimeError, match="libpng"):
        list(native_loader.frame_source(png, 64, 48, prefer_native=False))


def test_image_list_source(images, tmp_path):
    for p, _ in images:
        os.link(p, tmp_path / os.path.basename(p))
    names = [os.path.basename(p) for p, _ in images]
    (tmp_path / "files.txt").write_text("\n".join(names) + "\n\n")
    got = list(tds.image_list_source(str(tmp_path)))
    assert len(got) == len(images)
    assert all(g.dtype == np.uint8 and g.shape == (48, 64) for g in got)


# ------------------------------------------------------------- tracer


def test_spans_aggregate():
    import time

    tr = Tracer()
    for _ in range(5):
        with tr.span("a"):
            time.sleep(0.001)
    with tr.span("a"):
        with tr.span("b", block=True):
            pass
    s = tr.summary()
    assert s["a"]["n"] == 6
    assert s["a.b"]["n"] == 1
    assert s["a"]["mean_ms"] >= 0.5
    assert "p95_ms" in s["a"] and "max_ms" in s["a"]


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        pass
    assert tr.summary() == {}


def test_report_json_and_events(tmp_path):
    tr = Tracer(device="cpu")
    with tr.span("stage", block=True):
        pass
    tr.count("kernels.builds")
    assert "stage" in tr.report()
    p = tmp_path / "t.json"
    tr.write_json(str(p))
    tj = json.loads(p.read_text())
    assert tj["spans"]["stage"]["n"] == 1
    assert tj["counters"] == {"kernels.builds": 1} and tj["stages"] == {}
    assert [e["name"] for e in tr.events] == ["stage"]
    tr.reset()
    assert tr.summary() == {} and tr.events == []
    assert tr.counters == {"kernels.builds": 1}
