"""The port's dry run against the reference's, cell for cell, on a 4x4
mesh of 16 ranks, and ``diagnose``'s breakdown.

Two subprocesses run the same cells: the port's ``run_cell`` on a fake
group of 16 ranks, and the reference's ``run_cell`` on 16 forced host
devices with the reference test's own mesh monkeypatch plus Auto axes (JAX
0.9's ``jax.make_mesh`` makes Explicit axes, which the reference's
``with_sharding_constraint`` refuses; the reference is not edited).

Held equal: ``args_bytes_per_chip`` (the reference's argument bytes; the
port's local shard bytes), ``model_flops_per_chip``, ``hbm_bytes_per_chip``
and ``analytic_peak_bytes``. ``flops_per_chip`` is equal for the decode
and prefill cells (forward dots only). The train cell's differ by the
remat recompute: on one device the two counts are equal with remat off,
and with remat on the port counts 8.2% more (XLA drops part of the
recomputed forward, the port's ``torch.utils.checkpoint`` reruns all of
it); on the 4x4 mesh the gap is the same, 8.2%, so the train cell is held
within 10%. Collective bytes are printed, not held: DTensor and GSPMD
partition differently.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.device import cap_test_threads

cap_test_threads()

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["smollm-135m:decode_32k", "smollm-135m:prefill_32k",
         "smollm-135m:train_4k"]
KEYS = ("status", "args_bytes_per_chip", "model_flops_per_chip",
        "hbm_bytes_per_chip", "analytic_peak_bytes", "flops_per_chip",
        "collective_bytes_per_chip", "fits_hbm", "error")
TRAIN_FLOPS_RTOL = 0.10

_REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import jax
    from repro.launch import dryrun as dr
    import repro.launch.mesh as mesh_mod
    mesh_mod.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (4, 4), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    dr.make_production_mesh = mesh_mod.make_production_mesh
    out = {}
    for cell in sys.argv[1:]:
        arch, shape = cell.split(":")
        res = dr.run_cell(arch, shape, multi_pod=False, verbose=False)
        out[cell] = {k: res.get(k) for k in KEYS}
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import sys, json
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import diagnose, dryrun as dr
    dr.quiet()
    dr.init_fake_world(16)
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    out = {}
    for cell in sys.argv[1:]:
        arch, shape = cell.split(":")
        res = dr.run_cell(arch, shape, multi_pod=False, verbose=False,
                          mesh=mesh)
        out[cell] = {k: res.get(k) for k in KEYS}
    cost, *_ = dr.count_cell("smollm-135m", "decode_32k", mesh)
    rows, total = diagnose.collective_breakdown(cost, top=10 ** 6)
    top, _ = diagnose.collective_breakdown(cost, top=3)
    out["diagnose"] = {"rows_sum": sum(r[0] for r in rows), "total": total,
                       "collective_bytes": cost.collective_bytes,
                       "n_rows": len(rows), "top": [list(r) for r in top]}
    print(json.dumps(out))
""")


def _run(code: str) -> dict:
    code = f"KEYS = {KEYS!r}\n" + code
    r = subprocess.run([sys.executable, "-c", code, *CELLS], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                            "HOME": os.environ.get("HOME", str(ROOT)),
                            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    return _run(_REF), _run(_PORT)


@pytest.mark.parametrize("cell", CELLS)
def test_dryrun_cell_matches_reference(both, cell):
    ref, port = both[0][cell], both[1][cell]
    print(cell, "collective bytes/chip: port", port["collective_bytes_per_chip"],
          "reference", ref["collective_bytes_per_chip"])
    assert ref["status"] == "ok" and port["status"] == "ok", (ref, port)
    for k in ("args_bytes_per_chip", "model_flops_per_chip",
              "hbm_bytes_per_chip", "analytic_peak_bytes", "fits_hbm"):
        assert port[k] == ref[k], (k, port[k], ref[k])
    rel = abs(port["flops_per_chip"] / ref["flops_per_chip"] - 1)
    if cell.endswith("train_4k"):
        assert rel < TRAIN_FLOPS_RTOL, (port, ref)
    else:
        assert rel < 1e-9, (port, ref)


def test_diagnose_rows_sum_to_collective_bytes(both):
    d = both[1]["diagnose"]
    assert d["n_rows"] > 0 and d["collective_bytes"] > 0, d
    assert d["rows_sum"] == pytest.approx(d["collective_bytes"], rel=1e-12)
    assert d["total"] == d["rows_sum"]
    assert all(r[4] for r in d["top"]), d      # each names its source
