"""The PyTorch port imports neither jax, triton, any module of the JAX
package, the repository's JAX scripts, nor scikit-learn, hdbscan or
matplotlib (none is on the card's machine). Checked in a fresh subprocess,
because tests/conftest.py imports jax into every test process, and by a scan
of every source's import statements, the ones inside functions included:
only the plotting tools (LAZY_IMPORTS) import matplotlib, and only inside a
function."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
# top-level modules the port must not import: JAX, Triton, the JAX package,
# the repository's JAX scripts (scripts/bench_stem_parts*.py), and the host
# libraries of the JAX package's clustering and plots
FORBIDDEN = ("jax", "jaxlib", "flax", "triton", "ood_in_object_detection_tpu", "scripts",
             "bench_stem_parts", "bench_stem_parts2", "bench_stem_parts3", "bench_stem_parts4",
             "sklearn", "hdbscan", "matplotlib")
# (source, module): host tools that draw figures, as the JAX package's do,
# and import the library inside the function that draws
LAZY_IMPORTS = {("cli/embedding_plot.py", "matplotlib"), ("cli/process_results.py", "matplotlib")}


@pytest.mark.parametrize("modules", [
    # the main path and the CLI
    ["engine", "ood", "cli", "data", "eval", "constants", "core", "utils", "train", "parallel"],
    # the kernels' wrappers, the model and the probe scripts
    ["ops", "models", "scripts"],
])
def test_port_imports_no_jax_or_triton(modules):
    """Every module of the port under ``modules``, found by walking the
    package (pkgutil.walk_packages), imported in one fresh interpreter: none
    of jax, jaxlib, flax, triton or the JAX package ends up in sys.modules."""
    code = ("import importlib, pkgutil, sys\n"
            "import ood_in_object_detection_torch as P\n"
            "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')\n"
            f"         if m.name.split('.')[1] in {modules!r}]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
            "print(len(names), ','.join(bad) or '-')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split()
    assert int(count) >= 10, f"the walk found only {count} modules"
    assert bad == "-", f"the port imported {bad}"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port on the card and must not need JAX there,
    nor any module of the JAX package: every module its main path imports."""
    code = ("import sys, chip_smoke\n"
            "import ood_in_object_detection_torch.engine, ood_in_object_detection_torch.ood.pipeline\n"
            "import ood_in_object_detection_torch.ood.methods, ood_in_object_detection_torch.utils.weights\n"
            "import ood_in_object_detection_torch.scripts.bench_stem_parts\n"
            f"print(sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_fails_without_cuda():
    """On a machine without a card the smoke run exits non-zero and prints
    no result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _absolute_imports(path: Path):
    """(line, top-level module, inside a function) of every absolute import
    statement in a source, at any depth (module level, functions, methods)."""
    tree = ast.parse(path.read_text(), str(path))
    in_function = {id(n) for f in ast.walk(tree)
                   if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0], id(node) in in_function
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0], id(node) in in_function


def test_port_sources_name_no_forbidden_import():
    """No import statement of the port's sources or chip_smoke.py, lazy
    ones included (the subprocess walk sees only what importing a module
    runs), names a forbidden module, but for LAZY_IMPORTS' inside a
    function."""
    pkg = REPO / "ood_in_object_detection_torch"
    files = sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    bad = [f"{f.relative_to(REPO)}:{line} {mod}" for f in files
           for line, mod, lazy in _absolute_imports(f)
           if mod in FORBIDDEN and not (
               lazy and f.parent != REPO and (str(f.relative_to(pkg)), mod) in LAZY_IMPORTS)]
    assert not bad, bad
    lazy = {(str(f.relative_to(pkg)), mod) for f in files if f.parent != REPO
            for _, mod, _ in _absolute_imports(f) if mod in FORBIDDEN}
    assert lazy == LAZY_IMPORTS
