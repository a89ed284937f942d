"""Async host pipeline: mapping, loop closing and global BA off the tracking
thread.

Counterpart of hfnet_slam_tpu/slam/pipeline.py, with the same protocol:
  * `MappingWorker` (LocalMapping::Run) consumes keyframes the tracker
    enqueues and hands each finished one to the loop thread;
  * `LoopWorker` (LoopClosing::Run) runs place recognition and corrections,
    collapsing its backlog to the newest keyframe;
  * `GBAWorker` runs the detached, abortable global BA a correction asks
    for (mbStopGBA / mnFullBAIdx).
The map lock `map_lock` is an RLock (Map::mMutexMapUpdate): the tracker holds
it for a frame, the workers for their host sections (gather inputs, write
back, propagate); the device solves run without it on copies made under it,
and a result whose map moved meanwhile (store.big_change_idx) is discarded.

Differences from the reference that the port must respect:
  * torch tensors are not immutable and a launched kernel does not pin its
    inputs, so every input of work done off the lock is a copy made under it
    (the `_t` helpers copy; the device mirrors update out of place);
  * every thread stays on the default CUDA stream, so work from different
    threads is ordered on the card as it was issued; a tensor crossing
    threads needs no event;
  * grad mode and inference mode are thread-local and reach no worker, and
    each component draws its random numbers from its own torch.Generator,
    so the draws do not depend on how the threads interleave;
  * the workers hold the GIL while they run Python: the overlap is that of
    the device waits and of the native map library's calls, which release
    it.
A worker's exception is raised again by its next `drain()`.
"""
from __future__ import annotations

import queue
import threading
import time


class MappingWorker:
    """Consumes (store, kf) items: local mapping per keyframe, then the hand-
    off to the loop thread (or an inline loop closer without one)."""

    def __init__(self, system):
        self.system = system
        self.q: queue.Queue = queue.Queue()
        self.map_lock = threading.RLock()
        self.exc = None
        self.processed = 0
        # pause protocol (LocalMapping::RequestStop): loop corrections pause
        # MAPPING, never tracking; keyframes keep queueing meanwhile
        self._pause = threading.Event()
        self._busy = False
        self._thread = threading.Thread(target=self._run, name="hfnet-mapping", daemon=True)
        self._thread.start()

    # -- tracking-thread API -------------------------------------------------
    def enqueue(self, store, k: int):
        """LocalMapping::InsertKeyFrame."""
        self.q.put((store, int(k)))

    def queue_size(self) -> int:
        return self.q.qsize()

    # -- loop-closer API -----------------------------------------------------
    def request_pause(self, timeout: float = 30.0):
        """Pause between queue items and wait until the in-flight item ends
        (RequestStop + isStopped). Sets the mapper's BA abort flag so a long
        local BA yields at its next round."""
        self._pause.set()
        mapper = getattr(self.system, "mapper", None)
        if mapper is not None:
            mapper.abort_ba = True
        t0 = time.monotonic()
        while self._busy and time.monotonic() - t0 < timeout:
            time.sleep(0.002)
        if self._busy:
            from ..utils.log import warn

            warn(f"MappingWorker.request_pause: in-flight keyframe did not finish within "
                 f"{timeout:.0f}s; the correction proceeds concurrently (the staleness "
                 "guards discard conflicts)")

    def resume(self):
        """LocalMapping::Release."""
        self._pause.clear()

    def drain(self):
        """Block until every queued keyframe is processed; raise a worker
        exception again."""
        self.q.join()
        if self.exc is not None:
            exc, self.exc = self.exc, None
            raise exc

    def stop(self):
        self.q.put(None)
        self._thread.join(timeout=30)

    # -- worker thread -------------------------------------------------------
    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            store, k = item
            # _busy is set BEFORE the pause check and set again after it: in
            # the other order request_pause() could see a stale False in the
            # gap and return while this worker starts a keyframe
            self._busy = True
            while self._pause.is_set():
                self._busy = False
                time.sleep(0.002)
                self._busy = True
            try:
                sys_ = self.system
                with self.map_lock:
                    stale = store is not sys_.store or not store.kf_valid[k]
                if not stale:
                    # the local BA waits while more keyframes are queued (the
                    # reference's !CheckNewKeyFrames() gate)
                    sys_.mapper.process_keyframe(k, do_ba=self.q.qsize() == 0)
                    lw = getattr(sys_, "loop_worker", None)
                    if lw is not None:
                        lw.enqueue(store, k)
                    elif sys_.loop_closer is not None:
                        if sys_.loop_closer.process_keyframe(k):
                            with self.map_lock:
                                sys_.tracker.velocity = None
                    vi = getattr(sys_, "vi", None)
                    if vi is not None:
                        # the staged IMU initialization runs on this worker
                        # under the map lock: its rescale is a whole-map move
                        # the tracker must not interleave with
                        with self.map_lock:
                            vi.maybe_initialize(float(store.kf_timestamp[k]))
                self.processed += 1
            except Exception as e:  # raised again by drain()
                self.exc = e
            finally:
                self._busy = False
                self.q.task_done()


class LoopWorker:
    """The LoopClosing thread: place recognition and corrections on the
    keyframes the mapping worker finished, so detection never starves
    triangulation."""

    def __init__(self, system):
        self.system = system
        self.q: queue.Queue = queue.Queue()
        self.exc = None
        self.processed = 0
        self.skipped = 0  # keyframes superseded by a newer one in the backlog
        self._thread = threading.Thread(target=self._run, name="hfnet-loop", daemon=True)
        self._thread.start()

    def enqueue(self, store, k: int):
        """LoopClosing::InsertKeyFrame."""
        self.q.put((store, int(k)))

    def queue_size(self) -> int:
        return self.q.qsize()

    def drain(self):
        self.q.join()
        if self.exc is not None:
            exc, self.exc = self.exc, None
            raise exc

    def stop(self):
        self.q.put(None)
        self._thread.join(timeout=60)

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            # collapse the backlog to the NEWEST keyframe: detecting for an
            # old keyframe against the current map gives temporally
            # inconsistent corrections, and the newest one carries the same
            # place signal
            items = [item]
            stop = False
            while True:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                items.append(nxt)
            store, k = items[-1]
            self.skipped += len(items) - 1
            try:
                sys_ = self.system
                lock = sys_.worker.map_lock
                with lock:
                    stale = store is not sys_.store or not store.kf_valid[k]
                if not stale and sys_.loop_closer is not None:
                    if sys_.loop_closer.process_keyframe(k):
                        with lock:  # the map moved under the tracker
                            sys_.tracker.velocity = None
                self.processed += 1
            except Exception as e:  # raised again by drain()
                self.exc = e
            finally:
                for _ in items:
                    self.q.task_done()
                if stop:
                    self.q.task_done()  # the sentinel's own get
                    return


class GBAWorker:
    """Detached, abortable global bundle adjustment (the reference's
    transient GBA thread): a correction submits a request and returns; a
    newer request aborts the solve in flight, whose result is discarded."""

    def __init__(self, mapper):
        self.mapper = mapper
        self.q: queue.Queue = queue.Queue()
        self._abort = threading.Event()
        self.full_ba_idx = 0  # completed solves (mnFullBAIdx)
        self.aborted = 0
        self.exc = None
        self._thread = threading.Thread(target=self._run, name="hfnet-gba", daemon=True)
        self._thread.start()

    def request(self, kind: str, **kw):
        """Queue a global solve ('visual': run_global_ba keyword arguments;
        'inertial': full_inertial_ba's, FullInertialBA on the mapper's
        VIManager), aborting the one in flight and superseding a queued one
        (mbStopGBA = true)."""
        if kind not in ("visual", "inertial"):
            raise ValueError(f"GBAWorker.request: unknown kind {kind!r}")
        self.abort_inflight()
        stop_seen = False
        try:
            while True:  # a queued, unstarted solve is superseded
                stop_seen |= self.q.get_nowait() is None
                self.q.task_done()
        except queue.Empty:
            pass
        self.q.put((kind, kw))
        if stop_seen:  # never eat the stop sentinel
            self.q.put(None)

    def abort_inflight(self):
        self._abort.set()

    def drain(self):
        """Block until the queue is empty and the current solve ended; raise
        a worker exception again."""
        self.q.join()
        if self.exc is not None:
            exc, self.exc = self.exc, None
            raise exc

    def stop(self):
        self.abort_inflight()
        self.q.put(None)
        self._thread.join(timeout=60)

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            kind, kw = item
            self._abort.clear()
            aborted = self._abort.is_set
            try:
                if kind == "inertial":
                    self.mapper.full_inertial_ba(self.mapper.vim, should_abort=aborted, **kw)
                else:
                    self.mapper.run_global_ba(should_abort=aborted, **kw)
                if aborted():
                    self.aborted += 1
                else:
                    self.full_ba_idx += 1
            except Exception as e:  # raised again by drain()
                self.exc = e
            finally:
                self.q.task_done()


class _NullLock:
    """No-op lock of the synchronous pipeline: keeps `with self.lock:` and the
    release/acquire pairs around device waits uniform with the async one."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def acquire(self):
        pass

    def release(self):
        pass


NULL_LOCK = _NullLock()
