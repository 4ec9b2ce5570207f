"""The live step's cost against the map's capacity: K = 100, 300 and 1000.

The port's copy of the JAX package's ``tools/capacity_probe.py`` (numpy and
torch only; nothing of the JAX package). Every shipped configuration holds
1000 keyframe slots, while a live run fills them only over tens of
thousands of frames; this tool measures what the capacity alone costs the
step. For each K it builds the preset-shaped configuration (640x480, ORB
gate, 1000 features, 200 match lanes, 4096 point and 512 candidate slots,
``bench.py``'s preset mode) with ``max_keyframes`` K, and feeds the same
rendered ``PlaneScene`` sequence (``trajectory(frames,
translation_amp=1.0)``) through ``SdvlStream.feed_chunk`` in chunks of 16:
on the card one replay of a CUDA graph per chunk. The first chunk is the
capture and the bootstrap, the next two settle, the rest are timed, with
nothing read back before the last timing. A run never fills the store (a
few keyframes in 320 frames), so every K should track alike: the probe is
a pure cost-against-capacity measurement, and the runs at different K can
be held against each other.

Per K it prints one JSON line with the JAX tool's keys, each with its
meaning but two: ``compile_s`` is the first chunk's seconds (the port
captures the chunk's graph where JAX compiles), and ``map_state_mb`` the
port's own bytes (its index fields are int64). The port's own keys:
``capture_s`` and ``pool_mib`` of each chunk length's graph,
``replays_per_chunk``, ``syncs_after_capture`` (synchronisations in the
chunks that captured nothing), ``replay_ms_per_frame`` (the device time of
the timed chunks' replays, CUDA events, per frame), and the per-frame
``states``, ``is_keyframe``, ``n_matches`` and ``poses`` (the trajectory in
the final world frame).

    python -m sdvl_tpu_torch.tools.capacity_probe [--ks 100,300,1000]
        [--frames 320] [--device cuda|cpu] [--json out.json]

On the CPU cut the sizes (``--height``, ``--width``: the focal lengths and
principal point scale with the width).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

CHUNK = 16


def probe_config(height: int = 480, width: int = 640):
    """(scene, config) of the JAX tool (``:90-104``): the preset shape
    without its K knob (``max_keyframes`` left at 100); at another size the
    focal lengths and principal point scaled with the width."""
    from ..io.synthetic import PlaneScene
    from ..pipeline.config import CameraConfig, Config, SdvlConfig
    from .zurich_scale_smoke import zurich_camera

    c = zurich_camera(height, width)
    scene = PlaneScene(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                       width=width, height=height, plane_z=4.0)
    cfg = Config(
        camera=CameraConfig(width=width, height=height, fx=c["fx"],
                            fy=c["fy"], u0=c["cx"], v0=c["cy"],
                            dist=(0, 0, 0, 0, 0)),
        sdvl=SdvlConfig(use_orb=True, num_features=1000, max_matches=200,
                        max_points=4096, fast_threshold=10.0, cell_size=32,
                        min_avg_shift=10.0, min_keyframe_its=15,
                        min_init_corners=40, map_scale=4.0,
                        max_candidates=512),
    )
    return scene, cfg


def probe_frames(scene, n: int, workers: int = 0):
    """(ground-truth poses, uint8 frames) of the JAX tool's sequence
    (``:105-106``: clipped and truncated as it casts)."""
    from .zurich_scale_smoke import render_all

    poses = scene.trajectory(n, translation_amp=1.0)
    return poses, render_all(
        lambda p: np.clip(scene.render(p), 0, 255).astype(np.uint8), poses,
        workers)


def probe_one(K: int, frames, cfg_base, device="cuda", gumbel_provider=None,
              graphs=None, on_chunk=None, seed: int = 0) -> dict:
    """One capacity: ``cfg_base`` with ``max_keyframes`` K, a fresh
    ``SdvlStream`` (``seed``, ``device``, ``gumbel_provider`` and
    ``graphs`` go to it) fed ``frames`` in chunks of :data:`CHUNK`; the
    first chunk timed to its end (capture and bootstrap), two settle, the
    rest timed back to back. ``on_chunk(stream, feed)``, where given, is
    called for each chunk in place of ``feed()``, which feeds it. Returns
    the JAX tool's keys and the port's own (module docstring)."""
    from .. import require_device
    from ..pipeline.stream import SdvlStream
    from ..utils.trace import sync_sites
    from .zurich_scale_smoke import Spans, state_bytes, synchronize

    dev = require_device(device)
    cfg = dataclasses.replace(
        cfg_base, sdvl=dataclasses.replace(cfg_base.sdvl, max_keyframes=K))
    slam = SdvlStream(cfg, seed=seed, device=dev,
                      gumbel_provider=gumbel_provider, graphs=graphs)
    own, _ = state_bytes(slam.m)
    chunks = [np.ascontiguousarray(np.stack(frames[i: i + CHUNK]))
              for i in range(0, len(frames), CHUNK)]
    replays, syncs = [], []

    def feed(c):
        n0, g0 = slam.runner.replays, len(slam.runner.chunk_graphs)

        def go():
            if g0 and dev.type == "cuda":
                syncs.append(len(sync_sites(lambda: slam.feed_chunk(c))))
            else:
                slam.feed_chunk(c)

        if on_chunk is None:
            go()
        else:
            on_chunk(slam, go)
        replays.append(slam.runner.replays - n0)

    synchronize(dev)
    t0 = time.perf_counter()
    feed(chunks[0])
    slam.block()                      # capture + bootstrap
    compile_s = time.perf_counter() - t0

    for c in chunks[1:3]:
        feed(c)
    slam.block()
    timed = chunks[3:]
    span = Spans(dev)
    t0 = time.perf_counter()
    for c in timed:
        span.start()
        feed(c)
        span.stop()
    slam.block()
    dt = time.perf_counter() - t0
    n = sum(len(c) for c in timed)
    r = slam.result()
    graphs_ = slam.runner.chunk_graphs
    return {
        "metric": "capacity_probe",
        "max_keyframes": K,
        "step_ms_per_frame": dt / n * 1000,
        "fps": n / dt,
        "compile_s": compile_s,
        "map_state_mb": own / 1e6,
        "capture_s": {int(t): g.capture_s for t, g in graphs_.items()},
        "pool_mib": {int(t): g.pool_bytes / 2 ** 20
                     for t, g in graphs_.items()},
        "replays_per_chunk": replays,
        "syncs_after_capture": sum(syncs),
        "replay_ms_per_frame": span.ms() / n,
        "frames": len(frames),
        "states": r.states.tolist(),
        "is_keyframe": r.is_keyframe.astype(int).tolist(),
        "n_matches": r.n_matches.tolist(),
        "poses": r.trajectory.tolist(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ks", default="100,300,1000")
    ap.add_argument("--frames", type=int, default=20 * CHUNK)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from .. import require_device
    from .long_run import default_workers

    dev = require_device(args.device)
    scene, cfg = probe_config(args.height, args.width)
    _, frames = probe_frames(scene, args.frames, default_workers(dev))
    out = []
    for k in (int(x) for x in args.ks.split(",")):
        r = probe_one(k, frames, cfg, device=dev)
        out.append(r)
        print(json.dumps({k_: v for k_, v in r.items()
                          if k_ not in ("states", "is_keyframe",
                                        "n_matches", "poses")}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
