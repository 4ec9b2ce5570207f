"""The general generator and the two drivers of the benchmark.

A traffic file names its ``kind``; the kind's driver reads the rest of it
(sizes, lengths, trajectories, limits) and runs one cell once:
set-up (generation, program set-up, warm-up), the measured window, then
the comparison with the reference. A new mix of an existing kind is a new
traffic file and nothing else.

* ``live_map``: one live SLAM stream (``SdvlStream.feed``), each frame's
  result read on the host before the next frame is handed over.
* ``global_ba``: repeated whole-map bundle adjustment of a filled map,
  each solve on a freshly perturbed copy, its result read.

Each driver returns a ``Run``: what the metric readers read (per-frame
records, the window, the program's counters, the trace) and the numbers
compared, each with its limit.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from . import program, reference, scene, trace

STATE_RUNNING = 2


@dataclasses.dataclass
class Run:
    kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    ran_out: bool = False
    # per step of the window: host seconds (handed over, feed returned,
    # result read) and the step's row (10,), see program.pack
    steps: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None
    trace_at: int = 0
    trace_steps: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def settle() -> None:
    """End of set-up: what set-up made is moved out of the collector's
    reach (``gc.freeze``), so that a collection inside the window walks
    only what the window made."""
    import gc

    gc.collect()
    gc.freeze()


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed_loop(run: Run, seconds: float, n_max: int, step, trace_n: int,
               dev) -> None:
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed or
    ``n_max`` steps ran; ``step`` returns (t_fed, rows). With ``trace_n``
    the window ends in ``trace_n`` steps under the profiler, begun once
    ``seconds`` have passed (or when ``trace_n`` steps are left): the
    profiler slows the host while it records and the process after it, so
    it records last."""
    sync(dev)
    t_start = time.perf_counter()
    prof = None
    i = 0
    while i < n_max:
        if (trace_n and prof is None and run.trace is None
                and (time.perf_counter() - t_start >= seconds
                     or i >= n_max - trace_n)):
            prof = trace.start()
            run.trace_at = i
        t0 = time.perf_counter()
        t1, rows = step(i)
        t2 = time.perf_counter()
        run.steps.append((t0, t1, t2, rows))
        i += 1
        if prof is not None and i == run.trace_at + trace_n:
            break
        if not trace_n and t2 - t_start >= seconds:
            break
    if prof is not None:
        run.trace = trace.stop(prof)
        run.trace_steps = i - run.trace_at
    run.ran_out = i >= n_max and run.steps[-1][2] - t_start < seconds
    run.window_s = run.steps[-1][2] - t_start


def read_rows(info) -> np.ndarray:
    with trace.span("read"):
        return program.pack(info).cpu().numpy()


# ------------------------------------------------------------- live_map
def live_inputs(spec: dict, seed: int, dev, render: bool = True) -> dict:
    """The stream's true poses and (``render``) frames, host uint8, from
    the seed."""
    tr, cfg = spec["traffic"], spec["config"]["cfg"]
    cam = scene.Camera.from_cfg(cfg)
    sc, tj = tr["scene"], tr["trajectory"]
    tex = (scene.texture(sc["texture"], scene.seeded(seed, 1, device=dev),
                         dev) if render else None)
    plane = scene.Plane(tex, sc["extent"], sc["plane_z"])
    poses = scene.sweep(tr["frames"], tj["span"], tj["legs"], tj["y_amp"],
                        tj["yaw_amp"], tj["period"], tj["z_amp"],
                        scene.rng(seed, 2).uniform(size=3),
                        tj.get("ramp", 0))
    frames = (plane.render(poses, cam.rays(dev)).cpu().numpy() if render
              else None)
    return dict(cam=cam, plane=plane, poses=poses, frames=frames)


def live_check(spec, inputs, answers: np.ndarray, first: int,
               snap: dict) -> dict:
    """The numbers compared of a live map. ``answers`` (n, 10) are the
    program's rows of frames ``first ..``: each frame's pose error in
    pixels after its block's similarity, inf where the frame is not
    RUNNING; their median and 95th percentile, and the share of frames
    not RUNNING. ``snap`` is the program's map after the window
    (:func:`program.map_snapshot`): of its keyframes made in the window,
    and the points anchored at them, the largest keyframe pose error and
    the points' median depth error (:func:`reference.map_errors`)."""
    ck = spec["traffic"]["check"]
    n = len(answers)
    truth = inputs["poses"][first:first + n]
    ok = answers[:, 7] == STATE_RUNNING
    pts = inputs["plane"].grid_points(ck["grid"])
    px = reference.blockwise_px(answers[:, :7], truth, ok, pts,
                                inputs["cam"], ck["block"])
    px = np.where(np.isnan(px), np.inf, px)
    nums = dict(px_p50=reference.rank(px, 50),
                px_p95=reference.rank(px, 95),
                lost_pct=100.0 * float((~ok).mean()))
    kf = snap["kf_frame"] >= first
    pt = snap["pt_frame"] >= first
    window = dict(kf_pose=snap["kf_pose"][kf], kf_frame=snap["kf_frame"][kf],
                  pt_pos=snap["pt_pos"][pt], pt_frame=snap["pt_frame"][pt])
    nums.update(reference.map_errors(window, inputs["poses"], pts,
                                     inputs["cam"], inputs["plane"].z))
    lim = ck["limits"]
    return {k: (v, lim[k]) for k, v in nums.items()}


def run_live(spec: dict, seed: int, seconds: float, trace_n: int, dev,
             t_proc: float) -> Run:
    tr = spec["traffic"]
    run = Run("live_map")
    inputs = live_inputs(spec, seed, dev)
    frames = inputs["frames"]
    config = program.load_config(spec["config"]["cfg"])
    stream = program.open_stream(config, scene.seed_int(seed, 3), dev)
    warm = tr["warmup_frames"]
    for i in range(warm):
        read_rows(stream.feed(frames[i]))
    sync(dev)
    settle()
    run.setup_s = time.perf_counter() - t_proc

    def step(i):
        with trace.span("feed"):
            info = stream.feed(frames[warm + i])
        t1 = time.perf_counter()
        return t1, read_rows(info)

    run.extra["card_before"] = card_state(dev)
    timed_loop(run, seconds, len(frames) - warm, step, trace_n, dev)
    run.extra["card_after"] = card_state(dev)
    run.counters = program.counters(stream)
    run.extra["memory_peak_bytes"] = peak_bytes(dev)
    answers = np.stack([r[3] for r in run.steps])
    snap = program.map_snapshot(stream)
    del stream
    program.free_device_state()
    t = time.perf_counter()
    run.checks = live_check(spec, inputs, answers, warm, snap)
    run.extra["check_s"] = time.perf_counter() - t
    run.attempted = len(answers)
    run.failed = int((answers[:, 7] != STATE_RUNNING).sum())
    run.extra["keyframes"] = int(answers[:, 8].sum())
    return run


# ----------------------------------------------------------------- zurich
def zurich_inputs(spec: dict, seed: int, dev, render: bool = True) -> dict:
    """The filled map's geometry from the seed (or from the mix's own
    ``map.seed``, where it fixes one map for every run): the keyframes'
    true poses on ``PlaneScene``'s orbit from a seeded phase, their views,
    points on the plane, where each keyframe sees each point (in front,
    ``margin`` px inside) and the observation there, ``offset`` px off.
    The store keeps undistorted pixels, so observations and views are
    pinhole projections at the configuration's intrinsics, its lens
    left out."""
    tr, cfg = spec["traffic"], spec["config"]["cfg"]
    mp, sc = tr["map"], tr["scene"]
    seed = mp.get("seed", seed)
    cam = scene.Camera.from_cfg(cfg).pinhole()
    tex = (scene.texture(sc["texture"], scene.seeded(seed, 1, device=dev),
                         dev) if render else None)
    plane = scene.Plane(tex, sc["extent"], sc["plane_z"])
    phase0 = float(scene.rng(seed, 2).uniform(0, 4))
    kf_poses = scene.orbit(phase0 + np.arange(mp["keyframes"]) / 72.0,
                           mp["translation_amp"])
    g = scene.seeded(seed, 4, device=dev)
    lo = torch.tensor(mp["points_lo"], dtype=torch.float64, device=dev)
    hi = torch.tensor(mp["points_hi"], dtype=torch.float64, device=dev)
    xy = lo + (hi - lo) * torch.rand((mp["points"], 2), generator=g,
                                     device=dev, dtype=torch.float64)
    pts = torch.cat([xy, torch.full((mp["points"], 1), sc["plane_z"],
                                    dtype=torch.float64, device=dev)], 1)
    R = torch.as_tensor(scene.quat_to_matrix(kf_poses[:, :4]), device=dev)
    t = torch.as_tensor(kf_poses[:, 4:], device=dev)
    pc = torch.einsum("kij,pj->kpi", R, pts) + t[:, None]
    z = pc[..., 2]
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    m = mp["visible_margin_px"]
    seen = ((z > 0.1) & (u >= m) & (u <= cam.width - 1 - m)
            & (v >= m) & (v <= cam.height - 1 - m))
    off = mp["obs_offset_px"]
    obs_px = torch.stack([u + off, v + off], -1).float()
    imgs = plane.render(kf_poses, cam.rays(dev)) if render else None
    return dict(cam=cam, plane=plane, phase0=phase0, kf_poses=kf_poses,
                pts=pts.float(), seen=seen, obs_px=obs_px, imgs=imgs)


def zurich_map(config, z: dict, dev):
    return program.fill_map(
        config, torch.as_tensor(z["kf_poses"], dtype=torch.float32,
                                device=dev),
        z["imgs"], z["pts"], z["seen"], z["obs_px"])


# -------------------------------------------------------------- global_ba
def huber(cam) -> float:
    """sqrt(5.991) px on the unit plane, in float32 as the program sets
    its Huber threshold."""
    return float(np.sqrt(np.float32(5.991))
                 / np.float32(min(np.float32(cam.fx), np.float32(cam.fy))))


def ba_draw(spec, z: dict, seed: int, k: int, dev) -> tuple:
    """Solve ``k``'s perturbed keyframe poses (Kn, 7) and points (P, 3),
    float32: each pose composed with ``exp`` of a twist of ``pose_sigma``
    (the two oldest, the gauge, left), each point moved by ``point_sigma``
    (the port's ``tools/zurich_scale_smoke.perturb``). The draws are a
    pool of ``pool`` fixed by the map's seed, which every run works
    through in an order of its own seed's (warm-up solves, k < 0, draw
    outside it): every seed does the same work."""
    pt = spec["traffic"]["perturb"]
    base = spec["traffic"]["map"].get("seed", seed)
    if k >= 0:
        k = int(scene.rng(seed, 32).permutation(pt["pool"])[k % pt["pool"]])
    g = scene.seeded(base, 30, k, device=dev)
    kn = len(z["kf_poses"])
    xi = pt["pose_sigma"] * torch.randn((kn, 6), generator=g, device=dev,
                                        dtype=torch.float64)
    xi[:2] = 0.0
    poses = scene.se3_compose(scene.se3_exp(xi.cpu().numpy()),
                              z["kf_poses"]).astype(np.float32)
    pts = z["pts"] + pt["point_sigma"] * torch.randn(
        z["pts"].shape, generator=g, device=dev)
    return poses, pts


def ba_problem(z: dict) -> dict:
    """The reference's view of the BA problem: unit-plane observations,
    the observed mask of points seen twice or more, the gauge."""
    cam = z["cam"]
    seen = z["seen"].cpu().numpy()
    obs = z["obs_px"].double().cpu().numpy()
    uv = np.stack([(obs[..., 0] - np.float32(cam.cx)) / np.float32(cam.fx),
                   (obs[..., 1] - np.float32(cam.cy)) / np.float32(cam.fy)],
                  -1)
    free_pts = seen.sum(0) >= 2
    fixed = np.zeros(len(seen), bool)
    fixed[:2] = True
    return dict(obs_uv=uv, mask=seen & free_pts[None], free_pts=free_pts,
                fixed=fixed, huber=huber(cam))


def ba_numbers(prob: dict, ref: dict, poses, points, dev) -> dict:
    """An answer against the reference's: the excess of its Huber cost
    over the reference's optimum (on the reference's stage-2 mask), and
    its camera centres' largest distance from the reference's, in mm."""
    c_ref = reference.ba_cost(ref["poses"], ref["points"], prob["obs_uv"],
                              ref["mask"], prob["huber"], dev)
    c = reference.ba_cost(poses, points, prob["obs_uv"], ref["mask"],
                          prob["huber"], dev)
    free = ~prob["fixed"]
    d = np.linalg.norm(scene.centres(np.asarray(poses, np.float64))[free]
                       - scene.centres(ref["poses"])[free], axis=-1)
    return dict(cost_excess=c / c_ref - 1.0, centre_mm=1e3 * float(d.max()))


def ba_check(spec, prob, z, seed, solves: list, dev, solve=None) -> dict:
    """The numbers compared over a seeded sample of the window's solves
    (``solves``: (k, input poses, input points, answer poses, answer
    points)); ``solve`` puts another solver in the program's place (the
    control)."""
    ck = spec["traffic"]["check"]
    pick = scene.rng(seed, 31).choice(len(solves),
                                      min(ck["samples"], len(solves)),
                                      replace=False)
    worst = {}
    for i in sorted(pick):
        k, p_in, x_in, p_out, x_out = solves[i]
        ref = reference.bundle_adjust(
            p_in, x_in, prob["obs_uv"], prob["mask"], prob["fixed"],
            prob["free_pts"], prob["huber"], reference.Arith("float64"),
            ck["stage_iters"], dev)
        if solve is not None:
            p_out, x_out = solve(p_in, x_in)
        for name, v in ba_numbers(prob, ref, p_out, x_out, dev).items():
            worst[name] = max(worst.get(name, -math.inf), v)
    lim = ck["limits"]
    return {n: (v, lim[n]) for n, v in worst.items()}


def run_ba(spec: dict, seed: int, seconds: float, trace_n: int, dev,
           t_proc: float) -> Run:
    tr = spec["traffic"]
    run = Run("global_ba")
    config = program.load_config(spec["config"]["cfg"])
    intr = program.intrinsics(config)
    z = zurich_inputs(spec, seed, dev)
    m = zurich_map(config, z, dev)
    z["imgs"] = None
    kn = len(z["kf_poses"])
    stats_all = []

    def solve(k):
        poses, pts = ba_draw(spec, z, seed, k, dev)
        m_k = program.with_geometry(
            m, torch.as_tensor(poses, device=dev), pts)
        st = {}
        with trace.span("global_ba"):
            out = program.global_ba(m_k, intr, st)
        with trace.span("read"):
            res = (out.kf_pose[:kn].cpu().numpy(),
                   out.pt_pos.cpu().numpy())
            cg = st["cg_iterations"].cpu().numpy()
        stats_all.append(dict(cg=cg, capture_s=st.get("capture_s")))
        return (k, poses, pts.cpu().numpy()) + res

    for k in range(tr["warmup_solves"]):
        solve(-1 - k)
    stats_all.clear()
    sync(dev)
    settle()
    run.setup_s = time.perf_counter() - t_proc
    solves = []

    def step(i):
        solves.append(solve(i))
        return time.perf_counter(), None

    run.extra["card_before"] = card_state(dev)
    timed_loop(run, seconds, 10 ** 9, step, trace_n, dev)
    run.extra["card_after"] = card_state(dev)
    run.extra["memory_peak_bytes"] = peak_bytes(dev)
    cg = np.concatenate([s["cg"] for s in stats_all])
    caps = [s["capture_s"] for s in stats_all if s["capture_s"] is not None]
    run.counters = dict(cg_iters_per_lm_step=float(cg.mean()) if cg.size
                        else None,
                        ba_capture_s=float(np.mean(caps)) if caps else None,
                        solves=len(solves))
    del m
    program.free_device_state()
    t = time.perf_counter()
    run.checks = ba_check(spec, ba_problem(z), z, seed, solves, dev)
    run.extra["check_s"] = time.perf_counter() - t
    run.attempted = len(solves)
    run.failed = 0
    return run


KINDS = {"live_map": run_live, "global_ba": run_ba}


# ------------------------------------------------------------------ card
def peak_bytes(dev) -> int:
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.max_memory_allocated(dev))
    return 0


def card_state(dev) -> Optional[dict]:
    """The card's clocks, power draw, power limit and temperature by
    ``nvidia-smi`` (None off the card or without the tool)."""
    import shutil
    import subprocess

    if torch.device(dev).type != "cuda" or not shutil.which("nvidia-smi"):
        return None
    fields = ("name", "clocks.sm", "clocks.mem", "power.draw",
              "power.limit", "temperature.gpu")
    idx = torch.device(dev).index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits", "-i", str(idx)],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return dict(zip(fields, (v.strip() for v in out.strip().split(","))))
