"""The control: the plain reference put in the program's place, judged by
the same comparison as a run. It has to come out as not correct. The mix's
``check.control`` says how: ``precision``, the arithmetic (global BA: TF32,
the precision below the program's float32 with TF32 off), and ``answer``:
``own`` (each answer is its own), or ``previous`` (each frame answered
with the pose of the frame before: the guarantee that the map-building
configuration states, broken).

    python3 -m slam_bench.control --workload <cell> --seeds <n> ...
        [--steps N] [--precision float64|float32|tf32|bfloat16]
        [--answer own|previous] [--device cuda|cpu]

prints one JSON line per seed: the numbers compared, each with its limit,
and ``correct``. It runs none of the program: ``--steps`` is the number of
frames (solves) a run's window holds.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import drivers, manifest, reference


def _rows(poses: np.ndarray) -> np.ndarray:
    rows = np.zeros(poses.shape[:-1] + (10,))
    rows[..., :7] = poses
    rows[..., 7] = drivers.STATE_RUNNING
    return rows


def live(spec, seed, steps, dev, arith, answer) -> dict:
    """The reference tracker over the window's frames; a keyframe every
    ``check.control_keyframe_every`` frames, its map triangulated from
    its answers (:func:`reference.triangulated_map`)."""
    inp = drivers.live_inputs(spec, seed, dev)
    ck = spec["traffic"]["check"]
    warm = spec["traffic"]["warmup_frames"]
    plane = inp["plane"]
    ans = reference.align_images(inp["poses"][warm:], inp["frames"][
        warm:warm + steps], plane.tex, plane.extent, plane.z, inp["cam"],
        arith)
    if answer == "previous":
        ans = np.concatenate([inp["poses"][warm - 1:warm], ans[:-1]])
    kf = np.arange(0, len(ans), ck["control_keyframe_every"])
    snap = reference.triangulated_map(ans[kf], warm + kf, inp["poses"],
                                      plane.grid_points(ck["grid"]),
                                      inp["cam"])
    return drivers.live_check(spec, inp, _rows(ans), warm, snap)


def ba(spec, seed, steps, dev, arith, answer) -> dict:
    z = drivers.zurich_inputs(spec, seed, dev, render=False)
    prob = drivers.ba_problem(z)
    n = spec["traffic"]["check"]["samples"]
    solves = []
    for k in range(n):
        poses, pts = drivers.ba_draw(spec, z, seed, k, dev)
        out = reference.bundle_adjust(
            poses, pts.cpu().numpy(), prob["obs_uv"], prob["mask"],
            prob["fixed"], prob["free_pts"], prob["huber"], arith,
            spec["traffic"]["check"]["stage_iters"], dev)
        solves.append((k, poses, pts.cpu().numpy(), out["poses"],
                       out["points"]))
    return drivers.ba_check(spec, prob, z, seed, solves, dev)


KINDS = {"live_map": live, "global_ba": ba}


def checks(spec, seed, steps, dev, precision=None, answer=None) -> dict:
    """The control's numbers, each with its limit: the reference as the
    mix's ``check.control`` says unless ``precision`` or ``answer`` is
    given, over ``steps`` frames (solves), by default as many as a run's
    window holds (``check.window_steps``)."""
    ck = spec["traffic"]["check"]
    ctl = ck["control"]
    return KINDS[spec["traffic"]["kind"]](
        spec, seed, steps or ck["window_steps"], dev,
        reference.Arith(precision or ctl["precision"]),
        answer or ctl.get("answer", "own"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--precision", default=None,
                    choices=("float64", "float32", "tf32", "bfloat16"),
                    help="default: the mix's check.control")
    ap.add_argument("--answer", default=None, choices=("own", "previous"),
                    help="default: the mix's check.control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = manifest.load()
    cells = {w["name"]: w for w in bench["workloads"]}
    config, traffic = args.workload.split(".", 1)
    spec = manifest.pairing(bench, cells.get(args.workload, dict(
        name=args.workload, config=config, traffic=traffic, chips=1)))
    dev = torch.device(args.device)
    steps = args.steps or spec["traffic"]["check"]["window_steps"]
    for seed in args.seeds:
        ck = checks(spec, seed, steps, dev, args.precision, args.answer)
        ok = all(np.isfinite(v) and v <= lim for v, lim in ck.values())
        ctl = spec["traffic"]["check"]["control"]
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              precision=args.precision or ctl["precision"],
                              answer=args.answer or ctl.get("answer", "own"),
                              steps=steps,
                              correct=bool(ok),
                              check={n: {"value": v, "limit": lim}
                                     for n, (v, lim) in ck.items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
