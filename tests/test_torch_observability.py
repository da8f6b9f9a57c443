"""The port's `core/observability.py` on the CPU:

  * `SummaryWriter`'s scalars read back through tensorboard's event reader
    as the values written, in fp32, and as the same (tag, step, value)
    triples as the JAX package's writer (tf.summary) where tensorflow
    imports;
  * with `torch.utils.tensorboard` failing to import it writes nothing,
    makes no directory and raises nothing;
  * `device_trace` writes a trace that holds `annotate`'s region, lets
    its body's exceptions through unchanged, and runs its body when the
    profiler fails to start.
"""

import glob
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu_torch.core import observability as obs  # noqa: E402

SCALARS = [("train/loss", 0, 2.718281828459045), ("train/lr", 0, 1.5e-4),
           ("train/loss", 1, 1.4142135623730951), ("train/lr", 1, 3e-4)]


def read_scalars(log_dir: str) -> dict:
    """{(tag, step): value} of every event file under `log_dir`, through
    tensorboard's reader (which gives a torch `simple_value` and a
    tf.summary tensor alike as a tensor)."""
    from tensorboard.backend.event_processing.event_file_loader import \
        EventFileLoader
    from tensorboard.util import tensor_util

    out = {}
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.*"))):
        for event in EventFileLoader(path).Load():
            for v in event.summary.value:
                out[(v.tag, event.step)] = tensor_util.make_ndarray(v.tensor)
    return out


def _write(writer):
    for tag, step, value in SCALARS:
        writer.add_scalar(tag, value, step)
    writer.flush()


def test_writer_scalars_read_back(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    w = obs.SummaryWriter(str(tmp_path / "tb"))
    _write(w)
    w.close()
    got = read_scalars(str(tmp_path / "tb"))
    assert set(got) == {(t, s) for t, s, _ in SCALARS}
    for tag, step, value in SCALARS:
        assert got[(tag, step)].dtype == np.float32
        assert got[(tag, step)] == np.float32(value), (tag, step)


def test_writer_matches_jax_writer(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    pytest.importorskip("tensorflow")
    from ecamp_tpu.core.observability import SummaryWriter as JaxWriter

    w = obs.SummaryWriter(str(tmp_path / "port"))
    _write(w)
    w.close()
    _write(JaxWriter(str(tmp_path / "jax")))
    port, ref = (read_scalars(str(tmp_path / d)) for d in ("port", "jax"))
    assert len(ref) == len(SCALARS)
    assert port.keys() == ref.keys()
    for key in ref:
        assert port[key].dtype == ref[key].dtype
        assert port[key] == ref[key], key


def test_writer_without_tensorboard_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = obs.SummaryWriter(str(tmp_path / "tb"))
    _write(w)
    w.close()
    assert os.listdir(tmp_path) == []


def test_disabled_writer_writes_nothing(tmp_path):
    w = obs.SummaryWriter(str(tmp_path / "tb"), enabled=False)
    _write(w)
    w.close()
    assert os.listdir(tmp_path) == []


def test_device_trace_holds_the_annotated_region(tmp_path):
    with obs.device_trace(str(tmp_path)):
        with obs.annotate("ecamp_region"):
            torch.ones(8).add_(1)
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(trace) as f:
        assert "ecamp_region" in f.read()


def test_device_trace_lets_the_body_raise(tmp_path):
    class Boom(Exception):
        pass

    err = Boom("from the body")
    with pytest.raises(Boom) as info:
        with obs.device_trace(str(tmp_path)):
            raise err
    assert info.value is err


def test_device_trace_runs_the_body_when_the_profiler_fails(tmp_path,
                                                            monkeypatch):
    def refuse(self):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    ran = []
    with obs.device_trace(str(tmp_path)):
        ran.append(True)
    assert ran == [True]
    assert not glob.glob(str(tmp_path / "*.pt.trace.json"))
