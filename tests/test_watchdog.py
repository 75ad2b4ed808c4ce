"""Stall watchdog (utils/watchdog.py) + its cohort CLI plumbing.

The production behavior under test is recovery from a wedged device
runtime: a call blocked forever in native code, which no
exception handler can reach.  The watchdog makes the hang visible
(thread stacks on stderr) and self-terminating (exit 86 for a
supervisor), with .done markers making the restart exactly-once.
"""
import json
import time

import pytest

from ventjax.utils import watchdog as wd_mod
from ventjax.utils.watchdog import EXIT_CODE, StallWatchdog


@pytest.fixture(scope="module")
def study_root(tmp_path_factory):
    from ventjax.io.synthetic import write_study

    root = tmp_path_factory.mktemp("wd_study")
    write_study(str(root), shape=(64, 64, 8), vox=(1.5, 1.5, 10.0), seed=5)
    return str(root)


def test_fires_once_after_quiet_period(monkeypatch, capfd):
    # capfd (fd-level) rather than capsys: faulthandler writes to the real
    # file descriptor, which capsys' pseudo-file does not have.
    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    with StallWatchdog(0.15, label="unit") as wd:
        time.sleep(0.6)  # several poll intervals with no touch
    assert fired == [EXIT_CODE], "must fire exactly once, then stand down"
    err = capfd.readouterr().err
    assert "no unit progress" in err
    assert str(EXIT_CODE) in err
    assert "Thread" in err or "File" in err  # faulthandler stack dump


def test_touches_keep_it_quiet_and_exit_stops_it(monkeypatch):
    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    with StallWatchdog(0.3, label="unit") as wd:
        for _ in range(6):
            time.sleep(0.1)
            wd.touch()
    # Past the context the thread is stopped: even a long quiet period
    # cannot fire it.
    time.sleep(0.5)
    assert fired == []


def test_completion_during_diagnostics_stands_down(monkeypatch, capfd):
    """A run that completes while the watchdog is printing its stack dump
    must NOT be hard-exited: the post-diagnostics _stop re-check stands
    down (the residual check->exit window is documented as irreducible)."""
    import faulthandler

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    wd = StallWatchdog(0.15, label="unit")

    real_dump = faulthandler.dump_traceback

    def dump_and_complete(*a, **k):
        real_dump(*a, **k)
        wd._stop.set()  # the run finishes mid-diagnostics

    monkeypatch.setattr(faulthandler, "dump_traceback", dump_and_complete)
    with wd:
        time.sleep(0.6)  # quiet past the timeout: diagnostics fire
    time.sleep(0.2)
    assert fired == [], "completion during diagnostics must stand down"
    assert "no unit progress" in capfd.readouterr().err


def test_rejects_nonpositive_timeout():
    with pytest.raises(ValueError):
        StallWatchdog(0.0)


def test_exit_survives_broken_stderr(monkeypatch):
    """A dead stderr pipe (BrokenPipeError from the diagnostic print) must
    never prevent the hard exit — it happens in a finally."""
    import sys

    class DeadPipe:
        def write(self, *a):
            raise BrokenPipeError("log collector died")

        def flush(self):
            raise BrokenPipeError("log collector died")

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    monkeypatch.setattr(sys, "stderr", DeadPipe())
    with StallWatchdog(0.1, label="unit"):
        time.sleep(0.5)
    assert fired == [EXIT_CODE]


def test_cli_cohort_stall_timeout_fires_on_wedged_run(
        study_root, tmp_path, monkeypatch, capsys):
    """A run_cohort that goes quiet past --stall-timeout trips the
    watchdog (stubbed exit observed); a healthy run never does."""
    from ventjax.cli import main
    from ventjax.pipeline import cohort as cohort_mod

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    monkeypatch.setattr(cohort_mod, "run_cohort",
                        lambda *a, **k: time.sleep(0.8) or [])
    manifest = [{"id": "s0", "xenon": f"{study_root}/xenon.dcm",
                 "mask": f"{study_root}/mask"}]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    (tmp_path / "o").mkdir()  # the real run_cohort would create it
    rc = main(["cohort", "--manifest", mpath, "--out", str(tmp_path / "o"),
               "--max-defect", "1024", "--stall-timeout", "0.2"])
    assert rc == 0  # stubbed exit lets the (stub) run finish
    assert fired == [EXIT_CODE]
    assert "no cohort progress" in capsys.readouterr().err


def test_cli_cohort_stall_timeout_quiet_on_healthy_run(
        study_root, tmp_path, monkeypatch, capsys):
    from ventjax.cli import main

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    manifest = [{"id": "s0", "xenon": f"{study_root}/xenon.dcm",
                 "mask": f"{study_root}/mask"}]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    rc = main(["cohort", "--manifest", mpath, "--out", str(tmp_path / "o"),
               "--max-defect", "1024", "--stall-timeout", "600"])
    assert rc == 0
    assert fired == []
    summary = json.loads(capsys.readouterr().out)
    assert summary["valid"] == 1
