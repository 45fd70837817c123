"""The port's scenario command line (``python -m repro_torch.api.cli``)
and its supervised worker pool, on the CPU:

  * ``list`` and ``describe`` print the reference's text;
  * ``run sweep_smoke --device cpu --out DIR`` computes every cell, a
    second ``run --expect-cached`` is a cache no-op, and ``--force
    --expect-cached`` fails;
  * ``--jobs 2`` gives the serial manifest and payloads but for timings;
  * a worker killed mid-cell (the port's own chaos hook) has its cell
    retried on a fresh worker; the reference's chaos variable does not
    reach a port worker.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch.api import cli, execute, scenarios

pytestmark = pytest.mark.usefixtures("one_thread")

SRC = Path(__file__).resolve().parents[1] / "src"


def _cli(*args, env=None):
    """``python -m repro_torch.api.cli ...`` as a user runs it."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.run([sys.executable, "-m", "repro_torch.api.cli",
                           *args], capture_output=True, text=True, env=env,
                          timeout=600)


def _strip(obj):
    """A manifest or payload without its wall-clock fields."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("elapsed_s", "git_rev")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_list_matches_reference(ref, capsys):
    assert cli.main(["list"]) == 0
    mine = capsys.readouterr().out
    assert ref.cli.main(["list"]) == 0
    assert mine == capsys.readouterr().out
    for name in scenarios.names():
        assert f"  {name}" in mine


@pytest.mark.parametrize("full", [False, True], ids=["quick", "full"])
def test_describe_matches_reference(ref, capsys, full):
    for name in scenarios.names():
        args = ["describe", name] + (["--full"] if full else [])
        assert cli.main(args) == 0
        mine = capsys.readouterr().out
        assert ref.cli.main(args) == 0
        assert mine == capsys.readouterr().out, name


def test_run_then_expect_cached(tmp_path):
    out = tmp_path / "rs"
    first = _cli("run", "sweep_smoke", "--device", "cpu", "--out", str(out))
    assert first.returncode == 0, first.stderr
    assert "sweep_smoke: 4 computed, 0 cached" in first.stdout
    manifest = json.loads((out / "manifest.json").read_text())
    assert [c["status"] for c in manifest["cells"]] == ["computed"] * 4
    assert len(list((out / "cells").glob("*.json"))) == 4
    again = _cli("run", "sweep_smoke", "--device", "cpu", "--out", str(out),
                 "--expect-cached")
    assert again.returncode == 0, again.stderr
    assert "sweep_smoke: 0 computed, 4 cached" in again.stdout
    forced = _cli("run", "sweep_smoke", "--device", "cpu", "--out",
                  str(out), "--force", "--expect-cached")
    assert forced.returncode == 1
    assert "--expect-cached" in forced.stderr


def test_jobs_2_gives_the_serial_manifest(tmp_path, capsys):
    serial, par = tmp_path / "serial", tmp_path / "par"
    assert cli.main(["run", "sweep_smoke", "--device", "cpu", "--out",
                     str(serial)]) == 0
    assert cli.main(["run", "sweep_smoke", "--device", "cpu", "--out",
                     str(par), "--jobs", "2", "--force"]) == 0
    assert "4 computed" in capsys.readouterr().out
    m_ser = json.loads((serial / "manifest.json").read_text())
    m_par = json.loads((par / "manifest.json").read_text())
    assert _strip(m_par) == _strip(m_ser)
    for entry in m_par["cells"]:
        name = f"{entry['cell_hash']}.json"
        assert _strip(json.loads((par / "cells" / name).read_text())) == \
            _strip(json.loads((serial / "cells" / name).read_text()))


def test_killed_worker_is_retried(tmp_path, monkeypatch):
    kill_dir = tmp_path / "chaos"
    kill_dir.mkdir()
    ref_dir = tmp_path / "ref_chaos"
    ref_dir.mkdir()
    monkeypatch.setenv("REPRO_TORCH_CHAOS_KILL_DIR", str(kill_dir))
    monkeypatch.setenv("REPRO_CHAOS_KILL_DIR", str(ref_dir))
    said = []
    rs = execute(scenarios.sweep_smoke(), out_dir=tmp_path / "rs", jobs=2,
                 device="cpu", progress=said.append)
    assert (kill_dir / "killed").exists(), "the chaos hook never fired"
    assert not (ref_dir / "killed").exists()
    assert any("lost its worker; retry 1/2" in msg for msg in said), said
    assert [c.status for c in rs] == ["computed"] * 4
    serial = execute(scenarios.sweep_smoke(), save=False, device="cpu")
    assert _strip(rs.manifest) == _strip(serial.manifest)
