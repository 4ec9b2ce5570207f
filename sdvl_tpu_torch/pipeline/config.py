"""Configuration: all algorithm knobs as an explicit, immutable dataclass.

The port's own copy of ``sdvl_tpu/pipeline/config.py`` (same field names and
defaults, same ``.cfg`` files through :func:`load_cfg`), so that nothing of
the JAX package is imported. Capacities (features, keyframes, points) are
the tensor shapes of the whole pipeline. ``use_pallas_detect`` chooses the
reference's detection route, as there: its border rule (``ops/fast.py``). It
does not choose an implementation: the device does (the hand-written kernel
of ``ops/cuda/detect.py`` on a CUDA tensor, its plain torch version on a CPU
tensor).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    width: int = 640
    height: int = 480
    fx: float = 517.3
    fy: float = 516.5
    u0: float = 318.6
    v0: float = 255.3
    dist: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SdvlConfig:
    """Algorithm parameters (reference SDVL.* keys, config.cc:33-86)."""

    cell_size: int = 32
    min_avg_shift: float = 50.0
    max_matches: int = 150
    max_keyframes: int = 100
    use_orb: bool = False
    pyramid_levels: int = 5
    min_keyframe_its: int = 30
    min_matches: int = 20
    max_failed: int = 15
    max_search_keyframes: int = 5
    max_optim_pose_its: int = 10
    max_ransac_points: int = 5
    max_ransac_its: int = 100
    threshold_converged: float = 0.1
    min_init_corners: int = 50
    inlier_error_threshold: float = 2.0
    map_scale: float = 1.0
    max_align_level: int = 4
    min_align_level: int = 2
    max_img_align_its: int = 30
    align_patch_size: int = 4
    scale_min_dist: float = 0.25
    lost_ratio: float = 0.7
    patch_size: int = 8
    max_align_its: int = 10
    search_size: int = 6
    orb_size: int = 31
    max_fast_levels: int = 3
    fast_threshold: float = 10.0
    min_feature_score: float = 50.0
    num_features: int = 1000
    align_ground_plane: bool = True  # z=0-align the initial map (reference
                                     # Map::TransformInitialMap, map.cc:704)

    # --- capacities (static shapes: preallocated masked slots) ---
    max_points: int = 4096        # world-point slots
    max_candidates: int = 1024    # depth-filter candidate slots
    ransac_hypotheses: int = 64   # batched pose-RANSAC lane capacity; the
                                  #   effective count is min(this,
                                  #   max_ransac_its) so presets that lower
                                  #   Config::MaxRansacIts take effect
    epipolar_samples: int = 32    # samples along the epipolar segment
    epipolar_corner_gate: bool = False  # restrict epipolar samples to
                                  #   corner-like image structure (reference
                                  #   matcher.cc:123-230 scans detected
                                  #   corners only); kills period aliases
                                  #   on repetitive texture at the cost of
                                  #   a dense Shi-Tomasi pass in the mapper
    max_reobs: int = 512          # reobservation attempts per new keyframe
                                  #   (AddConnectionsPoints, map.cc:560-617)
    reloc_max_keyframes: int = 64 # relocalization lane budget: nearest-to-
                                  #   guess keyframes tried per LOST frame
                                  #   (bounds the lane fan-out at large
                                  #   keyframe capacities)
    reloc_escalate_after: int = 8 # kidnapped-robot escape hatch: after this
                                  #   many consecutive failed frames WHILE
                                  #   LOST, sweep ALL keyframes instead of
                                  #   the nearest reloc_max_keyframes (a
                                  #   teleport makes the pose guess garbage,
                                  #   so the spatial prior selects the wrong
                                  #   lanes; the reference's walk is always
                                  #   global, sdvl.cc:205-238). < 0 disables
                                  #   escalation; irrelevant when
                                  #   max_keyframes <= reloc_max_keyframes
                                  #   (the bounded pass is already global)
    use_pallas_detect: bool = False  # detection route: the Pallas kernel's
                                  #   (4-px border cut, score threshold in
                                  #   the map) instead of the plain route's
                                  #   (scored to the image edge); both run
                                  #   in the same CUDA kernel
    use_affine_illum: bool = False  # gain/bias photometric model in direct
                                  #   alignment (solvers/image_align.py) —
                                  #   capability the reference lacks; off by
                                  #   default to mirror its brightness-
                                  #   constancy assumption
    localize_only: bool = False   # serving mode: track against a frozen,
                                  #   prebuilt map (loaded from a snapshot)
                                  #   — no mapping stage runs and the
                                  #   stream starts in LOST so the first
                                  #   frame relocalizes


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    type: int = 1
    path: str = ""
    filename: str = "files.txt"
    fps: float = 30.0


@dataclasses.dataclass(frozen=True)
class Config:
    camera: CameraConfig = CameraConfig()
    sdvl: SdvlConfig = SdvlConfig()
    video: VideoConfig = VideoConfig()


# boolean knobs get explicit truthiness coercion in load_cfg ("false"/"0"
# must not truthy-convert to True); with `from __future__ import
# annotations` dataclass field types are strings
_BOOL_FIELDS = frozenset(
    f.name for f in dataclasses.fields(SdvlConfig)
    if f.type in (bool, "bool")
)

_KEYMAP = {
    # SDVL.* cfg key -> SdvlConfig field (only where names differ)
    "max_alignLevel": "max_align_level",
    "min_alignLevel": "min_align_level",
}


def _parse_opencv_yaml(path: str) -> dict:
    """Minimal OpenCV-YAML (flat `A.b: value`) parser.

    The reference reads these via cv::FileStorage (config.cc:88-164); the
    files are flat key/value so a regex parse keeps cv2 out of the core
    import path.
    """
    out = {}
    pat = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(.+?)\s*(#.*)?$")
    with open(path) as f:
        for line in f:
            if line.strip().startswith(("#", "%")):
                continue
            m = pat.match(line)
            if not m:
                continue
            key, raw = m.group(1), m.group(2).strip()
            if raw.startswith('"') and raw.endswith('"'):
                out[key] = raw[1:-1]
            else:
                try:
                    out[key] = int(raw)
                except ValueError:
                    try:
                        out[key] = float(raw)
                    except ValueError:
                        # tolerate a stray internal space in a numeric
                        # scalar (reference config_iclnuim.cfg:37 reads
                        # "max_keyframes: 100 0") by parsing the FIRST
                        # token only. The reference's cv::FileStorage
                        # (config.cc:134) can't read "100 0" as an int
                        # either and silently keeps the compiled-in
                        # default 100 (config.cc:60) — first-token parse
                        # lands on the same effective value without
                        # inventing digit-concatenated numbers ("3 5"
                        # must not become 35)
                        tok = raw.split()[0]
                        try:
                            out[key] = int(tok)
                        except ValueError:
                            try:
                                out[key] = float(tok)
                            except ValueError:
                                out[key] = raw
                        if not isinstance(out[key], str):
                            # the repair is deliberate but must be LOUD: a
                            # future multi-valued numeric field would
                            # otherwise parse as a plausible scalar with
                            # the tail silently discarded
                            import warnings

                            warnings.warn(
                                f"{path}: '{key}: {raw}' is not a valid "
                                f"scalar; keeping first token {tok!r} and "
                                f"discarding the rest",
                                stacklevel=3,
                            )
    return out


def load_cfg(path: str) -> Config:
    """Load a reference-format .cfg (e.g. ``configs/tum_f1.cfg``)."""
    kv = _parse_opencv_yaml(path)

    cam = CameraConfig(
        width=int(kv.get("Camera.width", 640)),
        height=int(kv.get("Camera.height", 480)),
        fx=float(kv.get("Camera.fx", 517.3)),
        fy=float(kv.get("Camera.fy", 516.5)),
        u0=float(kv.get("Camera.u0", 318.6)),
        v0=float(kv.get("Camera.v0", 255.3)),
        dist=tuple(float(kv.get(f"Camera.d{i}", 0.0)) for i in range(1, 6)),
    )
    video = VideoConfig(
        type=int(kv.get("Video.type", 1)),
        path=str(kv.get("Video.path", "")),
        filename=str(kv.get("Video.filename", "files.txt")),
        fps=float(kv.get("Video.fps", 30.0)),
    )
    sdvl_kwargs = {}
    fields = {f.name for f in dataclasses.fields(SdvlConfig)}
    for key, value in kv.items():
        if not key.startswith("SDVL."):
            continue
        name = key[5:]
        name = _KEYMAP.get(name, name)
        if name in fields:
            if name in _BOOL_FIELDS:
                # the cfg parser leaves unquoted non-numeric values as
                # strings; bool("false") would be True
                if isinstance(value, str):
                    value = value.strip().lower() not in (
                        "0", "false", "no", "off", "",
                    )
                else:
                    value = bool(value)
            sdvl_kwargs[name] = value
    return Config(camera=cam, sdvl=SdvlConfig(**sdvl_kwargs), video=video)


def intrinsics(cfg: Config):
    """Build the :class:`~sdvl_tpu_torch.core.camera.Intrinsics` of a
    Config."""
    from ..core.camera import Intrinsics

    c = cfg.camera
    return Intrinsics.create(
        c.fx, c.fy, c.u0, c.v0, dist=list(c.dist),
        width=c.width, height=c.height,
    )
