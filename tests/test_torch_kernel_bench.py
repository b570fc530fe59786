"""The port's kernel_bench: the reference's CSV rows and a fused calibration
that the serve driver's loader reads (on the CPU, at the reference's small
shapes, through the kernels' plain versions)."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro_torch.core.estimator import load_fused_calibration
from repro_torch.kernels.fused_prefill import ref as fused_ref
from repro_torch.launch import kernel_bench

ATTN_TOL = dict(rtol=1e-4, atol=2e-4)   # the port's attention tolerance


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
                      ("fused_prefill_", 3), ("chunk_prefill_sdpa_", 1),
                      ("chunk_prefill_plain_", 1)):
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


@pytest.mark.parametrize("cur_len", ["full", "partial", "zero"])
def test_attn_baseline_computes_chunk_prefill_ref(cur_len):
    """The one library call that ``attn_s`` times computes
    ``chunk_prefill_ref``'s function (smoke shapes P4 x T512 x C64 x hd64,
    on the CPU), so the calibration's two-pass time is of the same work:
    all T prefix tokens resident, a different partial length a plane, and
    none (the chunk's causal block alone)."""
    p, t, c, hd = 4, 512, 64, 64
    rng = np.random.RandomState(11)
    q, kc, vc = (torch.from_numpy(rng.randn(p, c, hd).astype(np.float32))
                 for _ in range(3))
    kd, vd = (torch.from_numpy(rng.randn(p, t, hd).astype(np.float32))
              for _ in range(2))
    n = {"full": [t] * p, "partial": [t - 1, 1, t // 2 + 7, 300],
         "zero": [0] * p}[cur_len]
    cur = torch.tensor(n, dtype=torch.int32).reshape(p, 1)
    got = kernel_bench.attn_baseline(q, kd, vd, kc, vc, cur)()
    want = fused_ref.chunk_prefill_ref(q, kd, vd, kc, vc, cur)
    torch.testing.assert_close(got, want, **ATTN_TOL)
