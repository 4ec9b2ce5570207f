"""Command-line entry point: run SLAM over a sequence, report poses and timing.

Counterpart of ``sdvl_tpu/cli/run.py``, with the same flags, log lines and
summary JSON keys. Runs on the CUDA device unless ``--device cpu`` is given;
with no card it fails rather than fall back to the CPU. On the card,
detection takes the hand-written kernel (``ops/cuda/detect.py``).

Usage:
  python -m sdvl_tpu_torch.cli.run --config configs/tum_f1.cfg \\
      --images SEQ_DIR --stream --global-ba --output traj.txt
  python -m sdvl_tpu_torch.cli.run --synthetic 100        # no dataset needed
  python -m sdvl_tpu_torch.cli.run --device cpu --synthetic 20

``--viz DIR`` writes feature overlays and map figures as PNGs (the host
driver while it runs, every ``--viz-every`` frames; the stream driver after
the run); the map figures need matplotlib, and without it the run stops
before its first frame. ``--live`` opens the interactive viewer where OpenCV
and a display are present, else warns and runs headless, as the JAX
program does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="reference-format .cfg (OpenCV YAML)")
    ap.add_argument("--images", default=None,
                    help="directory with a files.txt image list")
    ap.add_argument("--tum", default=None, metavar="SEQ_DIR",
                    help="TUM RGB-D sequence directory (rgb.txt + rgb/; "
                         "groundtruth.txt enables in-run ATE)")
    ap.add_argument("--euroc", default=None, metavar="SEQ_DIR",
                    help="EuRoC MAV sequence directory (mav0/cam0/data.csv; "
                         "state_groundtruth_estimate0 enables in-run ATE)")
    ap.add_argument("--filename", default="files.txt")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--output", default=None, help="TUM trajectory out path")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--no-native-loader", action="store_true",
                    help="decode frames without the native loader (binary "
                         "PGM only)")
    ap.add_argument("--trace", default=None,
                    help="trace the run (utils/trace.py) and write JSON "
                         "here at exit: span timings, the global BA's "
                         "device ms per stage and the kernels' build "
                         "counters; also prints the table")
    ap.add_argument("--snapshot", default=None,
                    help="write a resumable session checkpoint here at exit")
    ap.add_argument("--resume", default=None,
                    help="resume from a session checkpoint")
    ap.add_argument("--viz", default=None, metavar="DIR",
                    help="write feature-overlay and map PNGs here (the map "
                         "figures need matplotlib)")
    ap.add_argument("--live", action="store_true",
                    help="interactive viewer: tracking overlay + 3D map "
                         "windows at 10 Hz (keys: f follow, space pause, "
                         "q quit; mouse orbits, wheel zooms). Needs OpenCV "
                         "and a display, else runs headless; host driver "
                         "only")
    ap.add_argument("--viz-every", type=int, default=10)
    ap.add_argument("--async-mapping", action="store_true",
                    help="run the mapper on its own thread (default "
                         "sequential)")
    ap.add_argument("--global-ba", action="store_true",
                    help="refine the WHOLE map with full bundle adjustment "
                         "at end of run and rebase the trajectory by each "
                         "keyframe's correction")
    ap.add_argument("--localize", default=None, metavar="SNAPSHOT",
                    help="with --stream: localization-only serving against "
                         "the frozen map in a stream snapshot (session "
                         "starts LOST and relocalizes)")
    ap.add_argument("--stream", action="store_true",
                    help="the stream driver: per-frame results are read "
                         "once, at the end (per-frame prints happen at "
                         "exit)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="with --stream: frames per host->device copy")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pipeline runs (default cuda; no "
                         "fallback to the CPU)")
    args = ap.parse_args(argv)

    if args.viz:
        from ..viz.scene import require_matplotlib

        require_matplotlib()

    from .. import require_device
    from ..pipeline.config import (CameraConfig, Config, SdvlConfig,
                                   load_cfg)
    from ..pipeline.sdvl import SDVL

    device = require_device(args.device)
    if args.trace:
        from ..utils import trace

        trace.tracer().reset()
        trace.tracer().enabled = True
    stamps = []
    gt_poses = None
    if args.synthetic:
        from ..io.synthetic import PlaneScene

        scene = PlaneScene(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                           width=640, height=480, plane_z=4.0)
        cfg = Config(
            camera=CameraConfig(width=640, height=480, fx=517.3, fy=516.5,
                                u0=318.6, v0=255.3, dist=(0, 0, 0, 0, 0)),
            sdvl=SdvlConfig(min_avg_shift=10.0, min_init_corners=40,
                            map_scale=4.0),
        )
        poses = scene.trajectory(args.synthetic, translation_amp=1.0)
        gt_poses = np.stack(poses)
        frames = (scene.render(p) for p in poses)
    elif args.tum or args.euroc:
        if not args.config:
            ap.error("--config required with --tum/--euroc")
        cfg = load_cfg(args.config)
        from ..io import dataset as ds

        if args.tum:
            seq_stamps, paths = ds.tum_rgb_index(args.tum)
            args._seq_gt = _maybe(ds.load_tum_groundtruth, args.tum)
        else:
            seq_stamps, paths = ds.euroc_index(args.euroc)
            args._seq_gt = _maybe(ds.load_euroc_groundtruth, args.euroc)

        # indexed, so stamps stay aligned if an undecodable image is skipped
        from ..io.native_loader import frame_source

        indexed = frame_source(paths, cfg.camera.width, cfg.camera.height,
                               prefer_native=not args.no_native_loader,
                               indexed=True)
        used_stamps: list = []

        def _seq_frames():
            for i, img in indexed:
                used_stamps.append(seq_stamps[i])
                yield img

        frames = _seq_frames()
        args._seq_stamps = used_stamps
    else:
        if not args.config:
            ap.error("--config required unless --synthetic")
        cfg = load_cfg(args.config)
        if cfg.video.type == 0 and not args.images:
            # live camera (Video.type: 0)
            from ..io.dataset import camera_source

            frames = camera_source(width=cfg.camera.width,
                                   height=cfg.camera.height)
        else:
            path = args.images or cfg.video.path
            listfile = os.path.join(path, args.filename)
            with open(listfile) as f:
                names = [ln.strip() for ln in f if ln.strip()]
            paths = [os.path.join(path, n) for n in names]
            from ..io.native_loader import frame_source

            frames = frame_source(paths, cfg.camera.width, cfg.camera.height,
                                  prefer_native=not args.no_native_loader)

    if args.localize and not args.stream:
        ap.error("--localize requires --stream (the stream's serving path)")
    if args.localize and args.global_ba:
        # end-of-run BA would rewrite the frozen snapshot map and rebase
        # the served trajectory
        ap.error("--localize serves a frozen map; --global-ba would "
                 "modify it (drop one of the two)")
    if args.localize and args.resume:
        ap.error("--localize starts its own session from the snapshot; "
                 "it cannot be combined with --resume")
    if args.stream:
        if args.live:
            print("[WARN] --live needs per-frame host state; ignored "
                  "with --stream (use --viz for post-run rendering)")
        return _run_stream(args, cfg, frames, gt_poses, device)

    slam = SDVL(cfg, device=device)
    if args.resume:
        from ..io.snapshot import load_snapshot

        load_snapshot(slam, args.resume)
        print(f"[INFO] resumed from {args.resume} at frame {slam.frame_id}")
    async_mapper = None
    if args.async_mapping:
        from ..pipeline.runtime import AsyncMapper

        async_mapper = AsyncMapper(slam)

    recorder = None
    if args.viz:
        from ..viz import VizRecorder

        recorder = VizRecorder(args.viz, every=args.viz_every)

    live_ui = None
    if args.live:
        from ..viz import LiveUI

        if LiveUI.available():
            live_ui = LiveUI()
        else:
            print("[WARN] --live: no display/cv2 GUI available; "
                  "running headless (use --viz DIR instead)")

    times = []
    frame_states = {}
    n = 0
    for img in frames:
        t0 = time.perf_counter()
        img = np.asarray(img)
        info = slam.handle_frame(img)
        frame_states[info["frame_id"]] = info["state"]
        if recorder is not None:
            recorder.record(slam, img, info)
        if live_ui is not None:
            info["quality"] = slam.quality.name
            live_ui.update(slam, img, info)
        dt = (time.perf_counter() - t0) * 1e3
        times.append(dt)
        stamps.append(n / cfg.video.fps)
        if not args.quiet:
            p = info["pose"]
            print(f"[INFO] frame {n:5d} {info['state']:<12} "
                  f"matches {info['n_matches']:3d}/{info['n_attempts']:3d} "
                  f"t=({p[4]:+.3f} {p[5]:+.3f} {p[6]:+.3f}) "
                  f"{dt:6.1f} ms" + ("  [KF]" if info["keyframe"] else ""))
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
        if live_ui is not None and live_ui.quit_requested:
            print("[INFO] quit requested from viewer")
            break

    if live_ui is not None:
        live_ui.stop()
    if async_mapper is not None:
        async_mapper.stop()

    traj_ids = np.asarray([fid for fid, _ in slam.trajectory])
    traj = np.stack([p for _, p in slam.trajectory]) if slam.trajectory \
        else np.zeros((0, 7), np.float32)
    if args.global_ba:
        traj = _apply_global_ba(slam, cfg, traj, traj_ids)

    steady = times[min(20, len(times) // 2):]
    summary = {
        "frames": n,
        "keyframes": int(slam.m.kf_valid.sum()),
        "points": int(slam.m.pt_valid.sum()),
        "mean_ms": round(float(np.mean(steady)), 2) if steady else None,
        "fps": round(1e3 / float(np.mean(steady)), 2) if steady else None,
    }
    # ATE against the synthetic ground truth (frame ids of a resumed
    # session do not correspond to this run's rendered poses: skipped)
    if gt_poses is not None and len(traj) and not args.resume:
        in_gt = traj_ids < len(gt_poses)
        tracked = np.asarray([
            frame_states.get(int(fid)) == "RUNNING" for fid in traj_ids
        ]) & in_gt
        summary.update(_ate_vs_gt(
            traj, gt_poses[np.clip(traj_ids, 0, len(gt_poses) - 1)], tracked
        ))
    if args.tum or args.euroc:
        stamps = list(args._seq_stamps[:n])
        if len(traj) and not args.resume:
            tracked = np.asarray([
                frame_states.get(int(fid)) == "RUNNING" for fid in traj_ids
            ])
            summary.update(_ate_vs_seq_gt(
                args._seq_gt, np.asarray(stamps)[np.clip(traj_ids, 0, n - 1)],
                traj, tracked,
            ))
    print(json.dumps(summary))

    if args.trace:
        _write_trace(args.trace)

    if args.snapshot:
        from ..io.snapshot import save_snapshot

        save_snapshot(slam, args.snapshot)
        print(f"[INFO] session checkpoint written to {args.snapshot}")

    if args.output:
        from ..io.dataset import save_tum_trajectory

        save_tum_trajectory(args.output, stamps, traj)
        print(f"[INFO] trajectory written to {args.output}")
    return 0


def _maybe(loader, seq_dir):
    """Ground truth is optional in both dataset formats."""
    try:
        gt = loader(seq_dir)
        return gt if len(gt) else None
    except (OSError, ValueError):
        return None


def _ate_vs_seq_gt(gt, stamps, traj_wc, tracked=None):
    """Sim(3)-aligned ATE against dataset ground-truth rows
    [t, tx, ty, tz, qx, qy, qz, qw], associated by nearest timestamp."""
    import torch

    from ..core import se3
    from ..io import evaluate

    if gt is None:
        return {}
    stamps = np.asarray(stamps, np.float64)
    traj_wc = np.asarray(traj_wc)
    orig = np.arange(len(traj_wc))
    if tracked is not None and tracked.any():
        stamps, traj_wc, orig = (stamps[tracked], traj_wc[tracked],
                                 orig[tracked])
    ia, ib = evaluate.associate(stamps, gt[:, 0])
    if len(ia) < 3:
        return {}
    # TUM rows are cam->world [t, tx, ty, tz, qx, qy, qz, qw]; build
    # world->cam (w, x, y, z, t) poses, the pipeline's convention
    g = gt[ib]
    gt_cw = np.concatenate([g[:, [7, 4, 5, 6]], g[:, 1:4]], axis=1)
    gt_wc = se3.inverse(torch.from_numpy(gt_cw.astype(np.float32))).numpy()
    return _aligned_scores(traj_wc[ia], gt_wc, idx=orig[ia], suffix="_gt")


def _aligned_scores(traj_wc, gt_wc, idx=None, suffix=""):
    """Sim(3)-aligned ATE RMSE + TUM RPE (translation and rotation). The
    Umeyama scale feeds the RPE so relative translations are in
    ground-truth units; ``idx`` (each row's frame index) makes only truly
    adjacent frames count as one frame of drift."""
    from ..io import evaluate

    p_est = evaluate.positions_from_poses(traj_wc)
    p_gt = evaluate.positions_from_poses(gt_wc)
    s, R, t = evaluate.umeyama(p_est, p_gt, with_scale=True)
    aligned = (s * (R @ p_est.T)).T + t
    ate = float(np.sqrt(np.mean(
        np.linalg.norm(aligned - p_gt, axis=1) ** 2)))
    out = {f"ate_rmse{suffix}": round(ate, 4)}
    r = evaluate.rpe_tum(traj_wc, gt_wc, delta=1, scale=s, idx=idx)
    if r:
        out[f"rpe{suffix}"] = round(r["rpe_trans"], 4)
        out[f"rpe_rot_deg{suffix}"] = round(r["rpe_rot_deg"], 4)
    return out


def _ate_vs_gt(traj_wc, gt_wc, tracked=None):
    """Sim(3)-aligned ATE RMSE of the run against synthetic ground truth,
    over the ``tracked`` frames (pre-bootstrap identity poses would
    dominate the alignment otherwise)."""
    traj_wc = np.asarray(traj_wc)
    gt_wc = np.asarray(gt_wc)
    orig = np.arange(len(traj_wc))
    if tracked is not None and tracked.any():
        traj_wc, gt_wc, orig = traj_wc[tracked], gt_wc[tracked], orig[tracked]
    if len(traj_wc) < 3:
        return {}
    return _aligned_scores(traj_wc, gt_wc, idx=orig)


def _write_trace(path):
    """Print the process tracer's table, write its JSON to ``path`` and
    disable it."""
    from ..utils import trace

    tracer = trace.tracer()
    print(tracer.report())
    tracer.write_json(path)
    tracer.enabled = False
    print(f"[INFO] trace summary written to {path}")


def _apply_global_ba(slam, cfg, traj, traj_ids):
    """Full-map BA on the final map + trajectory rebase (both drivers),
    once, off the per-frame path."""
    from ..io.evaluate import rebase_trajectory
    from ..pipeline import mapper
    from ..pipeline.config import intrinsics

    m = slam.m
    # a copy: the host driver's map is storage written in place, and on
    # the CPU .numpy() would be a view of it
    kf_old = m.kf_pose.cpu().numpy().copy()
    m_new = mapper.global_ba(m, intrinsics(cfg))
    slam.m = m_new
    n_kf = int(m_new.kf_valid.sum())
    print(f"[INFO] global BA over {n_kf} keyframes / "
          f"{int(m_new.pt_valid.sum())} points")
    if len(traj) == 0:
        return traj
    return rebase_trajectory(
        traj, traj_ids, m.kf_frame_id.cpu().numpy(), kf_old,
        m_new.kf_pose.cpu().numpy(), m.kf_valid.cpu().numpy(),
    )


def _run_stream(args, cfg, frames, gt_poses=None, device="cuda"):
    """Stream driver: feed everything, read the results once, report.
    The per-frame log lines print after the run."""
    from ..pipeline.stream import STATE_NAMES, SdvlStream

    if args.localize:
        slam = SdvlStream.localizer(cfg, args.localize, device=device)
        print(f"[INFO] localization-only session against frozen map "
              f"{args.localize}")
    else:
        slam = SdvlStream(cfg, device=device)

    def _u8(img):
        # uint8 on the wire: 4x fewer host->device bytes than float32
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.round(np.clip(img, 0, 255)).astype(np.uint8)
        return img

    frames = map(_u8, frames)
    keep_frames = [] if args.viz else None
    if args.resume:
        from ..io.snapshot import load_stream_snapshot

        load_stream_snapshot(slam, args.resume)
        print(f"[INFO] resumed stream session from {args.resume}")
    n = 0
    n_warm = 0      # frames dispatched before the steady clock started
    t_first = None
    t0 = time.perf_counter()
    if args.chunk > 1:
        buf = []
        done = False
        for img in frames:
            buf.append(np.asarray(img))
            if keep_frames is not None:
                keep_frames.append(buf[-1])
            if args.max_frames and n + len(buf) >= args.max_frames:
                del buf[args.max_frames - n:]  # honour the limit exactly
                done = True
            if len(buf) == args.chunk or (done and buf):
                slam.feed_chunk(np.stack(buf))
                if n == 0:
                    t_first = time.perf_counter()
                    n_warm = len(buf)
                n += len(buf)
                buf.clear()
            if done:
                break
        if buf:
            for img in buf:
                slam.feed(img)
                n += 1
    else:
        for img in frames:
            img = np.asarray(img)
            if keep_frames is not None:
                keep_frames.append(img)
            slam.feed(img)
            if n == 0:
                t_first = time.perf_counter()
                n_warm = 1
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    slam.block()
    dt = time.perf_counter() - t0
    dt_steady = time.perf_counter() - (t_first or t0)
    n_steady = max(n - n_warm, 1)  # frames inside the steady window

    r = slam.result()
    traj = np.asarray(r.trajectory)
    if args.global_ba:
        traj = _apply_global_ba(slam, cfg, traj, np.arange(r.n_frames))
    if not args.quiet:
        for i in range(r.n_frames):
            p = r.trajectory[i]
            print(f"[INFO] frame {i:5d} {STATE_NAMES[int(r.states[i])]:<12} "
                  f"matches {int(r.n_matches[i]):3d}/"
                  f"{int(r.n_attempts[i]):3d} "
                  f"t=({p[4]:+.3f} {p[5]:+.3f} {p[6]:+.3f})"
                  + ("  [KF]" if r.is_keyframe[i] else ""))
    summary = {
        "frames": n,
        "keyframes": int(slam.m.kf_valid.sum()),
        "points": int(slam.m.pt_valid.sum()),
        "mean_ms": round(dt_steady / n_steady * 1e3, 3),
        "fps": round(n_steady / dt_steady, 2) if n > n_warm else None,
        "wall_s": round(dt, 2),
    }
    if gt_poses is not None and r.n_frames and not args.resume:
        k = min(r.n_frames, len(gt_poses))
        summary.update(_ate_vs_gt(
            traj[:k], gt_poses[:k],
            tracked=np.asarray(r.states)[:k] == 2,
        ))
    if (args.tum or args.euroc) and r.n_frames and not args.resume:
        k = min(r.n_frames, len(args._seq_stamps))
        summary.update(_ate_vs_seq_gt(
            args._seq_gt, np.asarray(args._seq_stamps[:k]), traj[:k],
            tracked=np.asarray(r.states)[:k] == 2,
        ))
    print(json.dumps(summary))
    if args.trace:
        _write_trace(args.trace)
    if args.viz:
        from ..viz import render_stream_session

        render_stream_session(slam, r, keep_frames, out_dir=args.viz,
                              every=args.viz_every)
        print(f"[INFO] visualization written to {args.viz}")
    if args.snapshot:
        from ..io.snapshot import save_stream_snapshot

        save_stream_snapshot(slam, args.snapshot)
        print(f"[INFO] session checkpoint written to {args.snapshot}")
    if args.output:
        from ..io.dataset import save_tum_trajectory

        if args.tum or args.euroc:
            stamps = list(args._seq_stamps[: r.n_frames])
        else:
            stamps = [i / cfg.video.fps for i in range(r.n_frames)]
        save_tum_trajectory(args.output, stamps, traj)
        print(f"[INFO] trajectory written to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
