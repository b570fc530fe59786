"""A run with the timed path broken underneath comes out not correct:
the served token altered where it is produced, a lane left as it was
(the entry never written into the cache), an entry changed between the
tier's put and its get. The chip check is skipped; the rest of the run
is the benchmark's own."""
import numpy as np
import pytest
import torch

from repro_torch.core.compression.base import CompressedEntry
from repro_torch.device import cap_test_threads
from repro_torch.models.model import Model
from repro_torch.serving import scheduler
from repro_torch.storage.tier import DRAMTier

from bench.tests.smoke import run_cell

cap_test_threads()


def _token_altered(monkeypatch):
    step = Model.decode_step

    def altered(self, *a, **k):
        logits, cache = step(self, *a, **k)
        return logits.roll(1, dims=-1), cache
    monkeypatch.setattr(Model, "decode_step", altered)


def _lane_unchanged(monkeypatch):
    def unwritten(cache, kv, cfg, lane, device):
        return int(kv["positions"].shape[0])
    monkeypatch.setattr(scheduler, "write_kvdata", unwritten)


def _entry_changed(monkeypatch):
    get = DRAMTier.get

    def changed(self, key):
        e = get(self, key)
        arrays = {k: np.array(v, copy=True) for k, v in e.arrays.items()}
        name = next(k for k, v in arrays.items() if v.dtype == np.float32)
        arrays[name].flat[0] += 1.0
        return CompressedEntry(e.method, e.rate, arrays, e.meta)
    monkeypatch.setattr(DRAMTier, "get", changed)


@pytest.mark.parametrize("fault", [_token_altered, _lane_unchanged,
                                   _entry_changed])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, last, _, err = run_cell("olmoe-smoke.doc_reuse", seed=9)
    assert rc == 0 and last is not None
    assert last["correct"] is False, err
