"""The port's pipelined extraction (hfnet_slam_torch/utils/prefetch.py):
the five checks of tests/test_prefetch.py on the port's pipeline_frames
(order, real overlap, lazy consumption, worker exceptions reaching the
consumer, worker cleanup), plus the port's extractor through it. The
hand-over between CUDA streams is checked on the card
(tests/test_torch_cuda.py)."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hfnet_slam_torch.utils.prefetch import pipeline_frames  # noqa: E402


class TestPipelineFrames:
    def test_order_and_completeness(self):
        out = list(pipeline_frames(lambda x: x * 10, range(7), lookahead=2))
        assert out == [(i, i * 10) for i in range(7)]

    def test_overlap_is_real(self):
        """With extraction and consumption both 20 ms, a serial loop takes
        >= n*40 ms, the pipeline ~ n*20 ms."""
        def extract(i):
            time.sleep(0.02)
            return i

        t0 = time.perf_counter()
        n = 8
        for _, _f in pipeline_frames(extract, range(n)):
            time.sleep(0.02)  # host tracking work
        dt = time.perf_counter() - t0
        assert dt < n * 0.04 * 0.85

    def test_lazy_consumption_of_infinite_stream(self):
        pulled = []

        def gen():
            i = 0
            while True:
                pulled.append(i)
                yield i
                i += 1

        it = pipeline_frames(lambda x: x, gen(), lookahead=1)
        for _ in range(3):
            next(it)
        assert len(pulled) <= 5
        it.close()

    def test_worker_exception_reaches_consumer(self):
        def extract(i):
            if i == 2:
                raise ValueError("bad frame")
            return i

        with pytest.raises(ValueError, match="bad frame"):
            list(pipeline_frames(extract, range(4)))

    def test_worker_thread_cleaned_up(self):
        before = {t.name for t in threading.enumerate()}
        list(pipeline_frames(lambda x: x, range(3)))
        time.sleep(0.05)
        after = [t for t in threading.enumerate()
                 if t.name.startswith("hfnet-extract")
                 and t.name not in before and t.is_alive()]
        assert after == []


def test_extractor_features_through_the_pipeline():
    """HFExtractor through pipeline_frames gives, frame by frame, the
    features of calling it directly."""
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.models.hfnet import HFNet

    ext = HFExtractor(HFNet(torch.Generator().manual_seed(1)), (64, 96), n_features=60,
                      n_levels=2, pad_to=64, device="cpu")
    frames = [np.random.default_rng(i).uniform(0, 255, (64, 96)).astype(np.float32)
              for i in range(4)]
    got = list(pipeline_frames(ext, frames, lookahead=2))
    assert [id(f) for f, _ in got] == [id(f) for f in frames]
    for img, feats in got:
        for a, b in zip(feats, ext(img)):
            assert torch.equal(a, b)
