"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names (the part
before the first dot) are compared whole: the program's name begins with
the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "atm_raytracer_tpu"}
PROGRAM = "atm_raytracer_tpu_torch"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax():
    for path in harness.HERE.rglob("*.py"):
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert PROGRAM not in imported_tops(path), path
        assert "portbench_runs" not in path.read_text()


def test_a_run_loads_no_jax():
    """Import every module a run and the control use, every metric reader,
    and the program's modules they drive, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, control, run, trace, bounds, device\n"
        "from portbench.reference import Reference, lowp\n"
        "harness.Program()\n"
        "b = harness.load_json(harness.BENCHMARK)\n"
        "[harness.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))\n"
    ) % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(out.stdout.split())
    assert PROGRAM in tops and "torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "atm_raytracer_tpu.fake", object())
    assert run.forbidden_modules() == ["atm_raytracer_tpu"]
    monkeypatch.delitem(sys.modules, "atm_raytracer_tpu.fake")
    assert "atm_raytracer_tpu" not in run.forbidden_modules()
