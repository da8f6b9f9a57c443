"""The port's thread `DataLoader` (ecamp_tpu_torch.data.loader) on the CPU:

  * its reorder buffer is bounded: with one worker slowed down, the batches
    built and not yet taken never exceed K * (queue size + 1);
  * in every mode (shuffled or not, last batch dropped or ragged) it yields
    the batches of `ecamp_tpu.data.loader.DataLoader`, one for one;
  * an abandoned iterator leaves no worker thread running.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from ecamp_tpu_torch.data import loader as loader_mod  # noqa: E402
from ecamp_tpu_torch.data.loader import DataLoader  # noqa: E402


class _Numbers:
    """Sample i is {"x": [i, draw]}, the draw from a stream reseeded per
    (epoch, worker), as the datasets' `reseed` protocol does. Worker 0
    sleeps `slow` seconds a sample."""

    def __init__(self, n, slow=0.0):
        self.n = n
        self.slow = slow
        self.wid = None
        self.rng = np.random.default_rng(0)

    def reseed(self, epoch, worker_id):
        self.wid = worker_id
        self.rng = np.random.default_rng(1000 * epoch + worker_id)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.wid == 0 and self.slow:
            time.sleep(self.slow)
        return {"x": np.array([i, self.rng.integers(1 << 30)], np.int64)}


def test_reorder_buffer_is_bounded_with_a_slow_worker(monkeypatch):
    """Worker 0 of 4 takes 20 ms a batch, the others none: the batches
    collated and not yet yielded stay within K * (QUEUE_SIZE + 1), where an
    unbounded reorder dict would hold most of the epoch."""
    made, taken, peak = [0], [0], [0]
    lock = threading.Lock()
    collate = loader_mod.default_collate

    def counting_collate(samples):
        out = collate(samples)
        with lock:
            made[0] += 1
            peak[0] = max(peak[0], made[0] - taken[0])
        return out

    monkeypatch.setattr(loader_mod, "default_collate", counting_collate)
    K = 4
    loader = DataLoader(_Numbers(160, slow=0.02), batch_size=1, shuffle=False,
                        num_workers=K)
    seen = []
    for batch in loader:
        with lock:
            taken[0] += 1
        seen.append(int(batch["x"][0, 0]))
    assert seen == list(range(160))
    assert peak[0] <= K * (loader_mod.QUEUE_SIZE + 1), peak[0]


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
@pytest.mark.parametrize("drop_last", [True, False], ids=["drop", "ragged"])
def test_batches_match_jax_loader(shuffle, drop_last):
    from ecamp_tpu.data.loader import DataLoader as JaxLoader

    kw = dict(shuffle=shuffle, seed=3, num_workers=3, drop_last=drop_last)
    jl = JaxLoader(_Numbers(23), 5, **kw)
    pl = DataLoader(_Numbers(23), 5, **kw)
    assert len(pl) == len(jl) == (4 if drop_last else 5)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == len(pl)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b["x"], a["x"])
        order = np.concatenate([b["x"][:, 0] for b in got])
        if not shuffle:
            np.testing.assert_array_equal(order, np.arange(len(order)))
        assert got[-1]["x"].shape[0] == (5 if drop_last else 3)


def test_abandoned_iterator_stops_its_workers():
    before = set(threading.enumerate())
    it = iter(DataLoader(_Numbers(200), batch_size=2, num_workers=4))
    next(it)
    workers = set(threading.enumerate()) - before
    assert len(workers) == 4
    it.close()  # the generator's finally: stop, then join the workers
    assert not any(t.is_alive() for t in workers)


def test_worker_failure_is_raised_in_order():
    """A sample that fails in its worker raises in the consumer when its
    batch is due, after every earlier batch was yielded."""

    class Failing(_Numbers):
        def __getitem__(self, i):
            if i == 7:
                raise ValueError("bad sample 7")
            return super().__getitem__(i)

    seen = []
    with pytest.raises(RuntimeError, match="worker failed") as info:
        for batch in DataLoader(Failing(12), batch_size=2, shuffle=False,
                                num_workers=3):
            seen.append(int(batch["x"][0, 0]))
    assert seen == [0, 2, 4]
    assert isinstance(info.value.__cause__, ValueError)
