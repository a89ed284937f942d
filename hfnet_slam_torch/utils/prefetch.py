"""Pipelined frame extraction: overlap the extraction of the next frame with
the tracking of this one.

Counterpart of hfnet_slam_tpu/utils/prefetch.py, with its contract: frames
come out in order, the iterable is pulled lazily (at most `lookahead`
frames ahead), an exception of the worker reaches the consumer, and the
worker thread is gone when the generator ends.

On a machine with CUDA the worker extracts on a stream of its own, so the
card can run the next frame's network while the consumer's stream runs
tracking. The handover is guarded both ways:
  * a frame goes to the worker with an event recorded on the consumer's
    stream when the frame was pulled; the worker's stream waits on it
    before extracting, so a frame the consumer's stream is still writing
    (an upload, preprocessing on the card) is read only once written. Its
    CUDA tensors are marked with `record_stream` for the worker's stream,
    so the caching allocator does not reuse their memory while the
    worker's reads are queued, even if the consumer drops the frame;
  * a result comes back with an event the consumer's stream waits on
    before it touches the tensors, which are marked with `record_stream`
    for the consumer's stream in the same way.

Usage:
    for image, feats in pipeline_frames(ext, frames):
        system.track_features(feats, t)
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import torch


def _cuda_tensors(x):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _cuda_tensors(v)


def pipeline_frames(extract_fn, frames, lookahead: int = 1):
    """Yield (frame, features) pairs with `extract_fn(frame)` for upcoming
    frames running on a background worker.

    extract_fn: callable(frame_item) -> features (a tensor, or tuples and
      lists of them, such as Features).
    frames: iterable of frame items (images, (image, depth) tuples, ...),
      numpy or torch, on the host or on the card.
    lookahead: how many frames to keep in flight (1 = double buffering).
    """
    side = torch.cuda.Stream() if torch.cuda.is_available() else None

    def work(item, ready):
        if side is None:
            return extract_fn(item), None
        with torch.cuda.stream(side):
            side.wait_event(ready)
            out = extract_fn(item)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def submit(item):
        ready = None
        if side is not None:
            # everything the consumer's stream has queued so far (the frame,
            # the weights) is visible to the worker's stream
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream())
            for t in _cuda_tensors(item):
                t.record_stream(side)
        return pool.submit(work, item, ready)

    def hand_over(fut):
        out, done = fut.result()
        if done is not None:
            consumer = torch.cuda.current_stream()
            consumer.wait_event(done)
            for t in _cuda_tensors(out):
                t.record_stream(consumer)
        return out

    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="hfnet-extract")
    q: collections.deque = collections.deque()
    try:
        for item in frames:
            q.append((item, submit(item)))
            if len(q) > lookahead:
                item0, fut = q.popleft()
                yield item0, hand_over(fut)
        while q:
            item0, fut = q.popleft()
            yield item0, hand_over(fut)
    finally:
        pool.shutdown(wait=True)
