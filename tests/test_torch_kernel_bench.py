"""The port's kernel_bench: the reference's CSV rows and a fused calibration
that the serve driver's loader reads (on the CPU, at the reference's small
shapes, through the kernels' plain versions)."""
import contextlib
import io
import json

import pytest
import torch

from repro_torch.core.estimator import load_fused_calibration
from repro_torch.launch import kernel_bench


def test_smoke_rows_and_calibration(tmp_path):
    out = tmp_path / "cal" / "fused_calibration.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = kernel_bench.main(["--device", "cpu", "--smoke", "--out",
                                str(out)])
    assert rc == 0
    rows = [r for r in buf.getvalue().splitlines() if not r.startswith("#")]
    names = [r.split(",")[0] for r in rows]
    for prefix, n in (("kivi_quant_", 6), ("kivi_dequant_", 6),
                      ("prefill_attn_", 2), ("decode_attn_", 3),
                      ("fused_prefill_", 3)):
        assert sum(x.startswith(prefix) for x in names) == n, prefix
    for r in rows:
        name, us, derived = r.split(",")
        assert float(us) > 0
    assert "decode_attn_8x1024x64_4b" in names
    assert "fused_prefill_4x512x64x64_4b" in names
    raw = json.loads(out.read_text())
    assert raw["backend"] == "cpu" and raw["bits"] == 4
    assert raw["shape"] == "P4xT512xC64xhd64"
    assert {"device", "power_limit"} <= set(raw)
    cal = load_fused_calibration(str(out))
    assert cal.fused_s > 0 and cal.dequant_s > 0 and cal.attn_s > 0
    assert 0.0 <= cal.residual_frac <= 1.0


def test_default_path_and_device():
    assert kernel_bench.CALIBRATION_PATH.endswith(
        "experiments/torch/fused_calibration.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kernel_bench.main(["--smoke"])
