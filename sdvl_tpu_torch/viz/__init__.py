"""Headless visualization (counterpart of ``sdvl_tpu/viz``): per-frame
feature overlays, map/trajectory figures (matplotlib, imported when drawn)
and a software-rendered 3D scene view; PNGs are written without OpenCV.
The interactive windows of :class:`LiveUI` need OpenCV and a display."""

from .overlay import draw_frame_overlay  # noqa: F401
from .scene import plot_map, plot_trajectory  # noqa: F401
from .recorder import VizRecorder, render_stream_session, save_png  # noqa: F401
from .live import LiveUI, Viewpoint, render_scene_view  # noqa: F401
