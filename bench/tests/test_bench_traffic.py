"""The traffic generator and the percentile arithmetic."""
import json

import numpy as np
import pytest

from repro_torch.device import cap_test_threads

from bench.metrics import percentile
from bench.spec import BENCH_DIR
from bench.tests.smoke import DATA
from bench.traffic import generator

cap_test_threads()

MIX = {"kind": "reuse", "doc_lengths": [40, 24, 64, 32], "tasks": [
    "qa", "summarization", "coding"], "probes_per_doc": 2, "zipf_a": 1.2,
    "max_new_tokens": 1, "dram_entries": 2, "ssd_entries": 2}


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    v = list(np.random.RandomState(q).exponential(size=37))
    assert percentile(v, q) == pytest.approx(np.percentile(v, q), abs=1e-12)


def test_percentile_of_a_failed_request_is_infinite_at_the_top():
    assert percentile([1.0, float("inf")], 100) == float("inf")
    assert percentile([1.0, 2.0, 3.0], 50) == 2.0


def test_due_times_fill_the_window_with_the_same_gaps():
    a = generator.due_times(40, 10.0, generator.rng_for(1, 1))
    b = generator.due_times(40, 10.0, generator.rng_for(2, 1))
    assert a[0] == 0 and a[-1] < 10.0 and np.all(np.diff(a) > 0)
    assert sorted(np.diff(np.append(a, 10.0))) == pytest.approx(
        sorted(np.diff(np.append(b, 10.0))))


def test_zipf_shares_and_counts():
    s = generator.zipf_mod_shares(1.2, 12)
    assert s.sum() == pytest.approx(1.0) and s.argmax() == 1
    c = generator.largest_remainder(s, 50)
    assert c.sum() == 50 and np.all(np.abs(c - 50 * s) < 1)


def test_every_seed_gets_the_same_work():
    mix = dict(MIX)
    big = 2 ** 31 + 5
    t1 = generator.generate(mix, 512, 3.0, 10.0, big)
    t2 = generator.generate(mix, 512, 3.0, 10.0, big + 1)
    t1b = generator.generate(mix, 512, 3.0, 10.0, big)
    assert len(t1.requests) == len(t2.requests) == 30

    def lens(t):
        by = {c.key: len(c.tokens) for c in t.contexts}
        return sorted(by[r.context_key] for r in t.requests)
    assert lens(t1) == lens(t2)
    def order(t):
        by = {c.key: (len(c.tokens), c.key) for c in t.contexts}
        return [by[r.context_key] for r in t.requests]
    assert order(t1) != order(t2)
    assert all(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(t1.contexts, t1b.contexts))
    assert all(r.max_new_tokens == 1 for r in t1.requests)


def test_an_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown traffic kind"):
        generator.generate(dict(MIX, kind="fresh"), 512, 3.0, 10.0, 1)


def test_max_prompt_holds_the_longest_question_and_answer():
    assert generator.max_prompt(MIX) == 64 + 2 + 1


MIX_FILES = sorted((BENCH_DIR / "traffic").glob("*.json")) + [
    DATA / "traffic" / "doc_reuse.json"]


@pytest.mark.parametrize("path", MIX_FILES, ids=lambda p: p.stem)
def test_every_question_has_two_tokens(path):
    """Every request takes the same two teacher-forced steps: a
    summarization question is its marker and the motif's first token,
    which the document repeats."""
    mix = json.loads(path.read_text())
    for seed in (3, 2 ** 31 + 7):
        t = generator.generate(mix, 512, 3.0, 20.0, seed)
        assert all(len(r.question) == 2 for r in t.requests)
        for c in t.contexts:
            assert all(len(q) == 2 for q in c.probes)
            if c.task_type == "summarization":
                assert all(q[0] == 7 and q[1] in c.tokens for q in c.probes)
