"""chip_smoke.py and its helpers, on the CPU: the device gate refuses the
CPU, the compile cache follows the environment, and every phase runs end
to end at a tiny size with the CPU standing in for the GPU."""

import json

import jax
import pytest

import chip_smoke
from gjkepa.utils import harness
from gjkepa.utils.workloads import SimScene

TINY = chip_smoke.Sizes(
    hull_pairs=64, hull_verts=12, deep_pairs=32, deep_verts=12,
    analytic_pairs=64, hull_shape_pairs=32, hull_shape_verts=12,
    sim_scenes=(SimScene(32, 256, 2, 3.0, 5.0),), sample=24, oracle=6,
    reps=1)


def test_device_gate_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        harness.require_gpu()
    assert "needs a GPU" in str(e.value)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_cache_dir_follows_env_else_fixed_path(tmp_path):
    env = {harness.CACHE_ENV: str(tmp_path / "c")}
    assert harness.compile_cache_dir(env) == (str(tmp_path / "c"), True)
    d1, from_env = harness.compile_cache_dir({}, root=tmp_path)
    assert not from_env and d1 == str(tmp_path / ".jax_cache")
    # the default root is the checkout, and the path is the same each time
    assert harness.compile_cache_dir({}) == harness.compile_cache_dir({})
    assert harness.compile_cache_dir({})[0].endswith(".jax_cache")


@pytest.mark.parametrize("phase", ["phase_c1", "phase_hulls", "phase_deep",
                                   "phase_analytic", "phase_sim"])
def test_phase_runs_tiny_on_cpu(phase, capsys):
    cpu = jax.devices("cpu")[0]
    ok = getattr(chip_smoke, phase)(cpu, cpu, TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ok and line["ok"], line
    assert line["calls"] and line["checks"]
    for call in line["calls"].values():
        assert call["compile_s"] > 0 and call["steady_s"] > 0


def test_sharded_phase_on_virtual_devices(capsys):
    devs = jax.devices("cpu")[:4]
    ok = chip_smoke.phase_sharded(devs, TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ok and line["ok"], line
    assert line["checks"]["result_devices"]["devices"] == 4
