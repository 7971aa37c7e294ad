"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions run end to end at a tiny size with the same bars as on the card
(the CPU rehearsal of the card run; the four-card phase uses four of the
suite's virtual CPU devices)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

TINY = dict(cells=640, genes=200, clones=4, new_cells=200)


def _no_json_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return not json.loads(lines[-1]).get("ok")
    except ValueError:
        return True


def _run_script(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    proc = _run_script(REPO)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert _no_json_result(proc.stdout)


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path))
    assert proc.returncode != 0
    assert _no_json_result(proc.stdout)


def test_main_returns_failure_in_process(capsys):
    assert cs.main([]) == 1
    assert _no_json_result(capsys.readouterr().out)


@pytest.fixture(scope="module")
def tiny():
    data = cs.make_dataset(seed=0, **TINY)
    return data, cs.phase_main(data, 0)


def test_dataset_is_host_integers(tiny):
    data, _ = tiny
    assert isinstance(data.Y, np.ndarray) and data.Y.dtype == np.int32
    assert data.Y.shape == (TINY["cells"], TINY["genes"])
    assert data.Y_new.shape == (TINY["new_cells"], TINY["genes"])
    assert data.L.shape == (TINY["genes"], TINY["clones"])


def test_phase_main(tiny):
    data, fit = tiny
    assert len(fit.multirun_info["elbos"]) == 9  # 3 shrinks x 3 repeats
    assert cs.accuracy(fit.clone, fit.clone_names, data.truth) >= cs.MIN_ACCURACY


def test_phase_precision(tiny):
    data, fit = tiny
    cs.phase_precision(fit, data, 0)


def test_phase_serving(tiny):
    data, fit = tiny
    cs.phase_serving(fit, data)


def test_phase_four_cards(tiny):
    data, _ = tiny
    cs.phase_four_cards(data, 0)


@pytest.mark.parametrize("name", list(cs.parity_cases()))
def test_parity_case(name):
    oracle = np.load(cs.ORACLE, allow_pickle=True)
    metrics, problems = cs.parity_cases()[name](oracle)
    assert not problems, (name, metrics, problems)


def test_z_cheb_on_example_is_measured():
    oracle = np.load(cs.ORACLE, allow_pickle=True)
    m = cs.z_cheb_on_example(oracle)
    assert np.isfinite(m["rel_err"]) and m["flips_vs_f32"] >= 0


def test_accuracy_counts_unassigned_as_wrong():
    names = ["a", "b"]
    assert cs.accuracy(["a", "unassigned", "b", "b"], names, [0, 0, 1, 0]) == 0.5


def test_parity_bars():
    oracle = {
        "t_elbo64": -1000.0,
        "t_clone32": np.array(["a", "b", "a"]),
        "t_clone64": np.array(["a", "b", "b"]),
    }
    probs = np.array([[0.99, 0.01], [0.01, 0.99], [0.951, 0.049]])
    clone = np.array(["a", "b", "a"])
    metrics, problems = cs.parity_problems("t", -1000.05, clone, probs, oracle)
    # one flip vs f64, at the 0.95 boundary: tolerated
    assert not problems and metrics["flips_vs_f64"] == 1
    # ELBO past 1e-4 relative, a flip vs the f32 oracle, and a flip vs f64
    # far from the boundary each fail
    probs_far = probs.copy()
    probs_far[2] = [0.7, 0.3]
    _, problems = cs.parity_problems(
        "t", -1000.2, np.array(["b", "b", "a"]), probs_far, oracle
    )
    assert len(problems) == 3
    # the fit's own MC noise floors the ELBO bar
    _, problems = cs.parity_problems("t", -1000.2, clone, probs, oracle, sd=0.1)
    assert not problems


def test_failed_phase_fails_its_dependents(monkeypatch):
    def boom(*args):
        raise RuntimeError("injected")

    monkeypatch.setattr(cs, "phase_main", boom)
    failed = cs.run_phases("main", False, TINY, 0)
    assert failed == ["main", "precision", "serving"]


def test_compile_stats_sees_backend_compiles():
    import jax
    import jax.numpy as jnp

    stats = cs.CompileStats()
    jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.25)(jnp.arange(7.0)).block_until_ready()
    assert stats.backend_compile_s > 0
    assert "backend_compile_s=" in stats.line(None)
