"""Nothing the benchmark loads is ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro``: module names compared by their whole top-level part
(``repro_torch`` begins with ``repro`` and is the program)."""
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.device import cap_test_threads

from bench import run

cap_test_threads()

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole(monkeypatch):
    fake = {"repro_torch.serving": None, "jaxtyping": None, "reprox": None,
            "flaxen.x": None}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(
        fake, **{"repro.core.policy": None, "jaxlib": None, "flax.nn": None}))
    assert run.forbidden_modules() == ["flax.nn", "jaxlib",
                                       "repro.core.policy"]


def test_a_run_loads_none_of_them():
    code = (
        "import json, sys, io, contextlib\n"
        "import torch\n"
        "from bench import run\n"
        "from bench.tests.smoke import spec\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out), "
        "contextlib.redirect_stderr(io.StringIO()):\n"
        "    rc = run.main(['--workload', 'deepseek-smoke.doc_reuse',"
        " '--seed', '3', '--seconds', '1', '--trace', '1'],"
        " device=torch.device('cpu'), spec=spec())\n"
        "last = json.loads(out.getvalue().strip().splitlines()[-1])\n"
        "from bench.run import forbidden_modules\n"
        "print(json.dumps({'rc': rc, 'correct': last['correct'],"
        " 'found': forbidden_modules(),"
        " 'port': 'repro_torch' in sys.modules}))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rc": 0, "correct": True, "found": [], "port": True}
