"""What the benchmark loads: no JAX and no JAX package in a run, compared by
whole top-level module names, and nothing of the program in the reference."""

import ast
import subprocess
import sys

from conftest import CELLS, ROOT


def test_holobench_forbidden_names_are_whole():
    from holobench import harness

    saved = dict(sys.modules)
    try:
        for name in ("jaxtyping", "slmsuite_torch_extra", "flaxen"):
            sys.modules.setdefault(name, type(sys)(name))
        assert harness.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & set(harness.FORBIDDEN))
        sys.modules["jax.numpy"] = type(sys)("jax.numpy")
        assert "jax" in harness.forbidden_modules()
    finally:
        for name in set(sys.modules) - set(saved):
            del sys.modules[name]


def test_holobench_run_loads_no_jax():
    """A rehearsal run checks ``sys.modules`` after its window and fails on
    a forbidden name; a module of the process that ran it reports none."""
    code = (
        "import sys, runpy, io, contextlib\n"
        f"sys.argv = ['run.py', '--workload', {CELLS[0]!r}, '--seed', '5',"
        " '--seconds', '0.3', '--trace', '0', '--rehearse']\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    try:\n"
        f"        runpy.run_path({str(ROOT / 'holobench' / 'run.py')!r}, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, e.code\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'slmsuite_tpu'}))\n"
        "assert 'slmsuite_torch' in tops\n"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return names


def test_holobench_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "holobench" / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in {"math", "numpy", "torch", "holobench"}, (path.name, name)
            if top == "holobench":
                assert name.startswith("holobench.reference"), (path.name, name)
    code = ("import sys; import holobench.reference.compressed; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'slmsuite_torch', 'slmsuite_tpu', 'jax', 'jaxlib', 'flax'}))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"
