"""Async tracker/mapper runtime: mapping on a thread and a map of its own.

Counterpart of ``sdvl_tpu/pipeline/runtime.py``. The tracker enqueues
frames and keyframes; the mapper thread folds them into the mapper's map
and the tracker publishes the newest complete version into its own map at
the start of each frame (:meth:`AsyncMapper.publish`), so it always tracks
against some complete map, at most a frame or two stale. Frame work is
dropped when the mapper is behind; keyframes never are. A mapper error
surfaces at the next tracker call.

Two maps, both fixed storage written in place. The tracker's (``slam.m``)
is read by its stages and written only by the publish; the mapper's is
written by each work item, a whole item at a time: on the card with graphs
(``slam.graphs``) one replay of the item's CUDA graph (``frame``: the
point-statistics fold and the depth-filter update; ``keyframe``: the fold,
keyframe insertion, local BA, pruning and the depth-filter update),
eagerly a copy of the new map into the storage. A lock makes each item's
write and each publish whole with respect to each other, so a publish never
copies half an item. The publish copies every field but the keyframe
pyramids, which only a keyframe item changes.

Ordering on the card. Both threads issue their work on one CUDA stream (the
one current where the mapper was made), and events order it as well: a work
item's inputs are copies the tracker makes and records an event after, which
the mapper waits for; the publish waits for the event recorded after the
newest item it copies. Every capture happens on the tracker's thread while
the mapper is idle (after :meth:`barrier`): a capture checks for
synchronisations process-wide, and no other thread may use the card during
it. On the CPU the worker thread takes the creating thread's intra-op thread
count (``torch.set_num_threads`` is per thread for OpenMP).
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Optional

import torch

from .. import const
from .device_fsm import StageGraph, StepState, _clone


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
        mapper.stop()                   # drain, join, publish the last map

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
        self._lock = threading.Lock()
        self._st: Optional[StepState] = None   # the mapper's map
        self._graphs = {}           # work kind -> StageGraph
        self._pool = None
        self._version = self._published = 0
        self._kf_dirty = False      # a keyframe item since the publish
        self._done = None           # CUDA event after the newest item
        # the stat fold's switch, made here: making a device constant
        # synchronises once
        self._stats_on = tuple(const(v, torch.bool, dev) for v in (False,
                                                                    True))
        slam._set_mapper(self)
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="sdvl-mapper")
        self.thread.start()

    @property
    def pool_bytes(self) -> int:
        """Device memory the work items' graphs took from their pool."""
        return sum(g.pool_bytes for g in self._graphs.values())

    # ------------------------------------------------------------- tracker side
    def submit_frame(self, tr, pyr, pose, stats_enabled=True) -> None:
        """Enqueue a tracked frame for the depth-filter update; dropped
        when the mapper is behind (the filters get fewer measurements).
        ``stats_enabled`` False: the frame recovered from LOST, its match
        failures must not decay point statistics."""
        self._check()
        if self.q.full():
            self.dropped_frames += 1
            return
        self.q.put(self._work("frame", tr, pyr, pose, stats_enabled))

    def submit_keyframe(self, tr, pyr, pose, frame_id, corners,
                        stats_enabled=True) -> None:
        """Enqueue keyframe insertion (+ local BA, pruning, map update).
        Blocks while the queue is full: keyframes are never dropped."""
        self._check()
        self.q.put(self._work("keyframe", tr, pyr, pose, stats_enabled,
                              frame_id, corners))

    def _work(self, kind, tr, pyr, pose, stats_enabled, *more) -> _Work:
        """A work item: copies of its inputs that no later tracker stage
        touches, the event after them, and on the card with graphs the
        item's graph (captured here, at its kind's first item, while the
        mapper is idle)."""
        slam = self.slam
        if self._st is None:
            self._st = StepState(_clone(slam.m), None, inplace=True)
        inputs = (self._stats_on[bool(stats_enabled)],) + _clone(
            (tr, pyr, pose, *more))
        if slam.graphs and kind not in self._graphs:
            self.barrier()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._graphs[kind] = StageGraph(
                f"mapper_{kind}", functools.partial(self._fold_stage, kind),
                self._st, inputs, pool=self._pool)
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record()
        return _Work(kind, (inputs, ready))

    def publish(self) -> None:
        """Copy the mapper's newest map into the tracker's (between tracker
        frames): every field, the keyframe pyramids only when a keyframe
        was folded in since the last publish."""
        self._check()
        with self._lock:
            if self._version == self._published:
                return
            if self._done is not None:
                torch.cuda.current_stream().wait_event(self._done)
            m = self._st.m
            if not self._kf_dirty:
                m = m._replace(kf_pyr=self.slam.m.kf_pyr)
            self.slam._st.update(m=m)
            self._published, self._kf_dirty = self._version, False

    def barrier(self, timeout: float = 60.0) -> None:
        """Wait until all enqueued work is folded in."""
        ev = threading.Event()
        self.q.put(_Work("barrier", (ev,)))
        ev.wait(timeout)
        self._check()

    def stop(self) -> None:
        """Drain the queue, join the thread, publish the last map and give
        the map's writes back to ``slam``."""
        self.barrier()
        self._stop.set()
        self.q.put(_Work("stop", ()))
        self.thread.join(timeout=60.0)
        self.publish()
        self.slam._set_mapper(None)
        self._graphs.clear()
        self._st = None
        self._check()

    def _check(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    # -------------------------------------------------------------- mapper side
    def _fold_stage(self, kind, st, *inputs):
        """One work item on the map of ``st``, written in place."""
        st.update(m=self.slam._mapping(st.m, kind == "keyframe", *inputs))

    def _fold(self, kind, inputs, ready) -> None:
        if ready is not None:
            torch.cuda.current_stream().wait_event(ready)
        g = self._graphs.get(kind)
        if g is None:
            m = self.slam._mapping(self._st.m, kind == "keyframe", *inputs)
        with self._lock:
            if g is None:
                self._st.update(m=m)
            else:
                g(*inputs)
            self._version += 1
            self._kf_dirty |= kind == "keyframe"
            if self._stream is not None:
                self._done = torch.cuda.Event()
                self._done.record()

    def _run(self):
        torch.set_num_threads(self._threads)
        if self._stream is None:
            self._loop()
            return
        with torch.cuda.device(self._stream.device), \
                torch.cuda.stream(self._stream):
            self._loop()

    def _loop(self):
        while not self._stop.is_set():
            work = self.q.get()
            try:
                if work.kind == "stop":
                    return
                if work.kind == "barrier":
                    work.payload[0].set()
                    continue
                self._fold(work.kind, *work.payload)
                self.processed += 1
            except BaseException as e:  # surfaces on the tracker thread
                self._exc = e
            finally:
                self.q.task_done()
