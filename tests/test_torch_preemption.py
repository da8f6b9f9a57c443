"""Preemption-safe pretraining in the port (`core/preemption.py`,
`cli/pretrain.py`), the counterpart of `tests/test_preemption.py`:
SIGTERM, `ECAMP_PREEMPT_AT_STEP` or host RSS above `--rss_limit_gb` makes
the CLI write `checkpoint-step-<step>.pth` at the exact micro-step and
exit, and `--resume` on it continues bit for bit (the RNG folds by step,
the loader's order is a function of (seed, epoch)), with and without
gradient accumulation.
"""

import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu_torch.ckpt.checkpoint import CYCLE_KEY  # noqa: E402
from ecamp_tpu_torch.cli import pretrain as cli  # noqa: E402
from ecamp_tpu_torch.core.preemption import PreemptionGuard  # noqa: E402
from test_torch_accum import (_corpus, cli_argv, read_log,  # noqa: E402
                              tiny_cli)

IMAGES = 16  # 4 micro-steps an epoch at B = 4, 8 in the 2 epochs


def test_guard_sigterm_sets_flag():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    try:
        assert not guard.should_save(1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.should_save(2)
        assert guard.reason == "signal"
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_fault_injection_env(monkeypatch):
    monkeypatch.setenv("ECAMP_PREEMPT_AT_STEP", "5")
    guard = PreemptionGuard()
    try:
        assert not guard.should_save(4)
        assert guard.should_save(5)
        assert guard.should_save(6)
        assert guard.reason == "injected @ 5"
    finally:
        guard.uninstall()


def test_guard_rss_watchdog(monkeypatch):
    """Host RSS above the limit reads as a preemption request, with its
    reason; a limit no process reaches never does. ECAMP_RSS_LIMIT_GB sets
    the limit where the caller gives none."""
    guard = PreemptionGuard(rss_limit_mb=1.0)  # every process is above 1 MB
    try:
        assert guard.host_rss_mb() > 1.0
        assert guard.should_save(1)
        assert guard.reason and "host RSS" in guard.reason
    finally:
        guard.uninstall()
    guard = PreemptionGuard(rss_limit_mb=float(2 ** 40))
    try:
        assert not guard.should_save(1)
        assert guard.reason is None
    finally:
        guard.uninstall()
    monkeypatch.setenv("ECAMP_RSS_LIMIT_GB", "0.5")
    guard = PreemptionGuard()
    try:
        assert guard.rss_limit_mb == 512.0
    finally:
        guard.uninstall()


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name.endswith("(work)") and t.is_alive()]


def _assert_same_final(ref, res):
    """checkpoint-1.pth of two runs: parameters, moments, AdamW's count
    and the open cycle equal bit for bit."""
    a, b = (torch.load(d / "checkpoint-1.pth", weights_only=True)
            for d in (ref, res))
    assert a["epoch"] == b["epoch"] == 1
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        other = b["optimizer"]["state"][i]
        assert int(st["step"]) == int(other["step"])
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[f], other[f]), (i, f)
    assert a.get(CYCLE_KEY) == b.get(CYCLE_KEY)


@pytest.mark.parametrize("accum,at,epoch,mini", [(1, 3, 0, None),
                                                 (2, 5, 1, 1)],
                         ids=["accum1_step3", "accum2_step5_midcycle"])
def test_preempt_resume_bitwise(tmp_path, monkeypatch, accum, at, epoch,
                                mini):
    """Preempt at micro-step `at` of 8 (mid-epoch; with accum 2 also
    mid-cycle), resume, and require the final checkpoint to equal an
    uninterrupted run's bit for bit. The preempted run leaves no loader
    thread behind and restores the SIGTERM handler."""
    root = _corpus(tmp_path, IMAGES)
    extra = ("--accum_iter", str(accum), "--epochs", "2")
    handler = signal.getsignal(signal.SIGTERM)
    with tiny_cli():
        cli.main(cli_argv(root, tmp_path / "ref", *extra))
    monkeypatch.setenv("ECAMP_PREEMPT_AT_STEP", str(at))
    with tiny_cli() as buf:
        cli.main(cli_argv(root, tmp_path / "pre", *extra))
    monkeypatch.delenv("ECAMP_PREEMPT_AT_STEP")
    path = tmp_path / "pre" / f"checkpoint-step-{at}.pth"
    assert (f"preemption checkpoint saved @ step {at} (epoch {epoch}); "
            f"resume with --resume {path} [injected @ {at}]"
            in buf.getvalue())
    assert not _loader_threads()
    assert signal.getsignal(signal.SIGTERM) is handler
    ck = torch.load(path, weights_only=True)
    assert ck["step"] == at and "epoch" not in ck
    assert ck.get(CYCLE_KEY, {}).get("mini_step") == mini
    assert not (tmp_path / "pre" / "checkpoint-1.pth").exists()

    with tiny_cli() as buf:
        cli.main(cli_argv(root, tmp_path / "pre", *extra, "--resume",
                          str(path)))
    assert f"resuming at epoch {epoch}, batch {at - 4 * epoch}" in \
        buf.getvalue()
    _assert_same_final(tmp_path / "ref", tmp_path / "pre")
    # the resumed run logs the epochs it finished: the last is finite and
    # equal to the uninterrupted run's where it saw the whole epoch
    ref, res = read_log(tmp_path / "ref"), read_log(tmp_path / "pre")
    assert res[-1]["epoch"] == 1 and np.isfinite(res[-1]["loss"])
    assert res[-1]["updates"] == ref[-1]["updates"] == 8 // accum
    if epoch == 0:
        assert res[-1] == ref[-1]


def test_rss_limit_saves_at_step_one_and_resumes(tmp_path):
    """`--rss_limit_gb` below the process's RSS saves at micro-step 1 with
    the RSS reason; the resume without it runs to the end and equals the
    uninterrupted run."""
    root = _corpus(tmp_path, IMAGES)
    with tiny_cli():
        cli.main(cli_argv(root, tmp_path / "ref", "--epochs", "2"))
    with tiny_cli() as buf:
        cli.main(cli_argv(root, tmp_path / "rss", "--epochs", "2",
                          "--rss_limit_gb", "0.001"))
    printed = buf.getvalue()
    assert "preemption checkpoint saved @ step 1 (epoch 0)" in printed
    assert "[host RSS" in printed
    assert not (tmp_path / "rss" / "log.txt").exists()
    with tiny_cli():
        cli.main(cli_argv(root, tmp_path / "rss", "--epochs", "2",
                          "--resume",
                          str(tmp_path / "rss" / "checkpoint-step-1.pth")))
    assert [r["epoch"] for r in read_log(tmp_path / "rss")] == [0, 1]
    _assert_same_final(tmp_path / "ref", tmp_path / "rss")
