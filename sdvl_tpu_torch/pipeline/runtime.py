"""Async tracker/mapper runtime: mapping on a thread of its own.

Counterpart of ``sdvl_tpu/pipeline/runtime.py``. The tracker enqueues
frames and keyframes; the mapper thread folds them into its map and
publishes each new :class:`~sdvl_tpu_torch.state.map_state.MapState` by a
single attribute store (``slam.m = m``), so the tracker always reads some
complete map, at most a frame or two stale. Frame work is dropped when the
mapper is behind; keyframes never are. A mapper error surfaces at the next
tracker call.

Why this is race-free in torch:

* Every map update on the mapper's path is out of place: ``MapState``
  fields are replaced by new tensors (``map_state.scatter`` concatenates a
  copy, ``set_row`` is ``index_copy``); the in-place writes on that path
  (``index_fill_``, ``index_put_``, ``fill_``, slice stores) all go to
  tensors the function has just allocated itself. So no kernel writes into
  a tensor the tracker may hold.
* Both threads issue their kernels on one CUDA stream (the stream current
  where the mapper was made), so every read the tracker issues is ordered
  with every write the mapper issues, and the caching allocator reuses a
  freed block only in stream order. Overlap on a second stream is later
  work.
* On the CPU the worker thread takes the creating thread's intra-op thread
  count (``torch.set_num_threads`` is per thread for OpenMP).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import torch


class _Work:
    __slots__ = ("kind", "payload")

    def __init__(self, kind: str, payload: tuple):
        self.kind = kind
        self.payload = payload


class AsyncMapper:
    """Background mapper for an :class:`~sdvl_tpu_torch.pipeline.sdvl.SDVL`.

    Usage::

        slam = SDVL(cfg)
        mapper = AsyncMapper(slam)      # takes ownership of map updates
        info = slam.handle_frame(img)   # tracker side
        mapper.stop()                   # drain + join

    While attached, ``slam.handle_frame`` routes the mapping work here
    instead of running it inline.
    """

    def __init__(self, slam, max_queue: int = 2):
        self.slam = slam
        self.q: "queue.Queue[_Work]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self.dropped_frames = 0
        self.processed = 0
        self._exc: Optional[BaseException] = None
        self._threads = torch.get_num_threads()
        dev = slam.device
        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)
        slam._async_mapper = self
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="sdvl-mapper")
        self.thread.start()

    # ------------------------------------------------------------- tracker side
    def submit_frame(self, tr, pyr, pose, stats_enabled=True) -> None:
        """Enqueue a tracked frame for the depth-filter update; dropped
        when the mapper is behind (the filters get fewer measurements).
        ``stats_enabled`` False: the frame recovered from LOST, its match
        failures must not decay point statistics."""
        self._check()
        try:
            self.q.put_nowait(_Work("frame", (tr, pyr, pose, stats_enabled)))
        except queue.Full:
            self.dropped_frames += 1

    def submit_keyframe(self, tr, pyr, pose, frame_id, corners,
                        stats_enabled=True) -> None:
        """Enqueue keyframe insertion (+ local BA, pruning, map update).
        Blocks while the queue is full: keyframes are never dropped."""
        self._check()
        self.q.put(_Work("keyframe",
                         (tr, pyr, pose, frame_id, corners, stats_enabled)))

    def barrier(self, timeout: float = 60.0) -> None:
        """Wait until all enqueued work is folded in."""
        ev = threading.Event()
        self.q.put(_Work("barrier", (ev,)))
        ev.wait(timeout)
        self._check()

    def stop(self) -> None:
        self.barrier()
        self._stop.set()
        self.q.put(_Work("stop", ()))
        self.thread.join(timeout=60.0)
        self.slam._async_mapper = None
        self._check()

    def _check(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    # -------------------------------------------------------------- mapper side
    def _run(self):
        torch.set_num_threads(self._threads)
        if self._stream is None:
            self._loop()
            return
        with torch.cuda.device(self._stream.device), \
                torch.cuda.stream(self._stream):
            self._loop()

    def _loop(self):
        slam = self.slam
        while not self._stop.is_set():
            work = self.q.get()
            try:
                if work.kind == "stop":
                    return
                if work.kind == "barrier":
                    work.payload[0].set()
                    continue
                if work.kind == "frame":
                    tr, pyr, pose, stats_on = work.payload
                    m = slam._update_stats(slam.m, tr, stats_on)
                    m = slam._update_map(m, pyr, pose)
                elif work.kind == "keyframe":
                    tr, pyr, pose, frame_id, corners, stats_on = work.payload
                    m = slam._update_stats(slam.m, tr, stats_on)
                    m, slot = slam._add_keyframe(
                        m, pyr, pose, frame_id,
                        tr.match_pt_idx, tr.match_px, tr.match_ok,
                        tr.match_level,
                        corners.xy, corners.level, corners.valid,
                    )
                    m = slam._local_ba(m, slot)
                    m = slam._prune(m)
                    m = slam._update_map(m, pyr, pose)
                else:  # pragma: no cover
                    continue
                # publish: one attribute store of a complete map
                slam.m = m
                self.processed += 1
            except BaseException as e:  # surfaces on the tracker thread
                self._exc = e
            finally:
                self.q.task_done()
