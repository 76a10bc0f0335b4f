"""What the benchmark's processes load: the references nothing of the
program, and a whole run nothing of JAX or the JAX package. Modules are
compared by their whole top-level name (the part before the first dot):
threedgrut_torch begins with the letters of threedgrut_tpu and is allowed.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "portbench" / "reference"
PROGRAM = {"threedgrut_torch"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})"
         f"\n{code}\nimport json; print(json.dumps(sorted("
         f"{{m.split('.')[0] for m in sys.modules}})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_sources_import_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        names = top_level_imports(path)
        assert not names & (PROGRAM | set(run.FORBIDDEN)), (path, names)
        assert names <= {"__future__", "math", "typing", "numpy", "torch",
                         "portbench"}, (path, names)


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after("import portbench.reference.train")
    assert not mods & (PROGRAM | set(run.FORBIDDEN))


def test_a_run_loads_no_jax():
    code = f"""
sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
import types, torch
from conftest import shrink
from portbench import cells, run
m, w, cfg, traffic, limits = run.cell("gut_mcmc_train")
cfg, traffic = shrink(cfg, traffic)
args = types.SimpleNamespace(workload=w["name"], seed=3, seconds=0.5,
                             trace=0, step_log=None)
assert run.run_cell(cells, w, cfg, traffic, limits, m, args,
                    torch.device("cpu"), 0.0) == 0
"""
    mods = loaded_after(code)
    assert "threedgrut_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "threedgrut_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "threedgrut_torch.ops", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert set(run.forbidden_modules()) == before | {"jaxlib"}
