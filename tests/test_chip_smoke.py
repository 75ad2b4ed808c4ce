"""chip_smoke.py's contract, checked where there is no GPU: it refuses a
non-GPU device and a checkout without the package, printing no result, and
its last line has the contract's shape."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_gate_rejects_cpu(smoke):
    with pytest.raises(SystemExit):
        smoke.require_gpu(jax.devices()[0])
    smoke.require_gpu(types.SimpleNamespace(platform="gpu",
                                            device_kind="NVIDIA H100"))


def test_result_line_has_the_contract_shape(smoke):
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = smoke.result_line(dev, 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", VENTJAX_NO_CACHE="1")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_the_cpu_and_prints_no_result(tmp_path):
    r = _run([SCRIPT], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_refuses_to_run_without_the_repo(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "ventjax" in r.stderr
