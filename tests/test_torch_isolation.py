"""The port stands alone: it imports with JAX blocked, names nothing of the
JAX package, and its simulator stays clean under the static checker."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'repro_torch.kernels.kivi.kernel' in names, names\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules), 'imported the JAX package'\n"
        "import importlib.util as u\n"
        f"spec = u.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 30


def test_no_file_imports_jax_or_the_reference():
    pat = re.compile(r"import jax|^\s*from jax|from repro[. ]|import repro\b"
                     r"(?!_torch)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_files()
                 if pat.search(p.read_text())]
    assert offenders == []


def test_simcheck_clean_on_the_port():
    proc = subprocess.run([sys.executable, "-m", "tools.simcheck",
                           "src/repro_torch", "--no-baseline"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
