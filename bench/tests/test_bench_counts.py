"""The byte and FLOP counters: KIVI bytes at the kernel table's shapes
(``chip_smoke.py``'s arithmetic), model FLOPs of one decode step against
the port's dispatch counter (``launch/step_cost.py``)."""
import json

import pytest
import torch

from repro_torch.device import cap_test_threads
from repro_torch.launch.step_cost import count_step
from repro_torch.models import Model

from bench import counts
from bench.rig import port_config
from bench.tests import jamba
from bench.tests.smoke import DATA
from bench.weights import make_params

cap_test_threads()


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_kivi_bytes_at_the_kernel_table_shape(bits):
    rows, cols, gs = 32 * 512, 1024, 64          # chip_smoke's phase 2
    n_el, n_groups = rows * cols, rows * cols // gs
    table = n_el * 4 + n_el * bits / 8 + 2 * n_groups * 4
    assert counts.kivi_bytes(n_el, bits, gs) == table


@pytest.mark.parametrize("name", ["olmoe-smoke", "deepseek-smoke",
                                  "jamba-smoke"])
def test_decode_flops_match_the_step_counter(name, monkeypatch):
    """A hybrid's Mamba layers count their projections, and in a decode
    step the conv window and the state's contraction with C, which the
    port runs as products there."""
    jamba.install(monkeypatch)
    hf = json.loads((DATA / "configs" / f"{name}.json").read_text())
    _, cfg = port_config(hf, name)
    p = make_params(cfg, 3, torch.device("cpu"), dtype=torch.float32)
    model = Model(cfg)
    cap = 48
    cache = model.init_cache(batch=1, capacity=cap, device="cpu")
    _, cost = count_step(model.decode_step, p, cache, cap - 1,
                         torch.tensor([[5]]), cap - 1)
    assert counts.decode_flops(hf, cap) == pytest.approx(cost.flops, rel=1e-9)


def test_prefill_counts_the_causal_half():
    hf = json.loads((DATA / "configs" / "olmoe-smoke.json").read_text())
    one, two = counts.prefill_flops(hf, 1), counts.prefill_flops(hf, 2)
    per_row = 2 * hf["num_hidden_layers"] * 2 * hf["hidden_size"]
    dense = one - per_row
    assert two - one == pytest.approx(
        dense - 2 * hf["hidden_size"] * hf["vocab_size"] + 2 * per_row)
