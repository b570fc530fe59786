"""The port's roofline formulas and step cost counter against the
reference's.

``model_flops``, ``analytic_hbm_bytes`` and ``analytic_peak_bytes`` are
bit-equal to the reference's for every assigned arch x shape x kv_bits x
chip count; the reference's three roofline tests hold at the H100
constants; the counter's matmul FLOPs equal the reference HLO walker's on
its own cases (one matmul, a loop of 7, nested 3 x 5).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_rl
from repro.launch.hlo_cost import analyze_hlo
from repro_torch.configs import ASSIGNED, get_config, get_shape
from repro_torch.device import cap_test_threads
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as rl
from repro_torch.launch.step_cost import count_step
from repro_torch.models import build_model

cap_test_threads()


@functools.lru_cache(maxsize=None)
def _counts(arch):
    m = build_model(get_config(arch))
    return m.param_count(), m.active_param_count()


@pytest.mark.parametrize("arch", ASSIGNED)
def test_formulas_bit_equal_to_reference(arch):
    n, na = _counts(arch)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for rshape in REF_SHAPES:
        shape = get_shape(rshape.name)
        assert rl.model_flops(cfg, shape, n, na) == \
            ref_rl.model_flops(rcfg, rshape, n, na)
        for chips in (256, 512):
            for bits in (16, 4):
                assert rl.analytic_hbm_bytes(cfg, shape, n, na, chips,
                                             kv_bits=bits) == \
                    ref_rl.analytic_hbm_bytes(rcfg, rshape, n, na, chips,
                                              kv_bits=bits)
                for opt_b in (8.0, 2.25):
                    assert rl.analytic_hbm_bytes(
                        cfg, shape, n, na, chips, kv_bits=bits,
                        opt_bytes_per_param=opt_b) == \
                        ref_rl.analytic_hbm_bytes(
                            rcfg, rshape, n, na, chips, kv_bits=bits,
                            opt_bytes_per_param=opt_b)
            args = 1.5e9 + chips
            assert rl.analytic_peak_bytes(cfg, shape, n, chips, args) == \
                ref_rl.analytic_peak_bytes(rcfg, rshape, n, chips, args)


def test_constants_are_the_h100s():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.ICI_BW == 50e9
    assert tmesh.HBM_BYTES == 85017493504


def test_model_flops_includes_attention():
    cfg = get_config("qwen3-1.7b")
    tr = get_shape("train_4k")
    mf = rl.model_flops(cfg, tr, 2_030_000_000, 2_030_000_000)
    dense = 6.0 * 2_030_000_000 * tr.global_batch * tr.seq_len
    assert mf > dense                     # attention term present
    dec = get_shape("decode_32k")
    mfd = rl.model_flops(cfg, dec, 2_030_000_000, 2_030_000_000)
    assert mfd < mf / 100                 # decode is tiny compute


def test_analytic_memory_quantized_kv():
    cfg = get_config("qwen3-1.7b")
    dec = get_shape("decode_32k")
    full = rl.analytic_hbm_bytes(cfg, dec, 2_030_000_000, 2_030_000_000,
                                 256, kv_bits=16)
    q4 = rl.analytic_hbm_bytes(cfg, dec, 2_030_000_000, 2_030_000_000,
                               256, kv_bits=4)
    assert q4 < 0.45 * full               # KV dominates; ~4x on that part


def test_roofline_bottleneck_logic():
    r = rl.Roofline("a", "s", "m", 256, flops=tmesh.PEAK_FLOPS_BF16,
                    hbm_bytes=1.0, collective_bytes=1.0,
                    collective_detail={}, model_flops_per_chip=500e12)
    assert r.bottleneck == "compute"
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0 / tmesh.HBM_BW)
    assert r.t_collective == pytest.approx(1.0 / tmesh.ICI_BW)
    assert 0 < r.roofline_fraction <= 1.0


def _walker(f, *shapes):
    args = [jnp.zeros(s) for s in shapes]
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text()).flops


def _counter(f, *shapes):
    return count_step(f, *[torch.zeros(s) for s in shapes])[1].flops


def test_counter_single_matmul():
    want = _walker(lambda a: a @ a, (128, 128))
    assert want == 2 * 128 ** 3
    assert _counter(lambda a: a @ a, (128, 128)) == want


def test_counter_loop_of_seven():
    def scanned(x, w):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=7)[0]

    def loop(x, w):
        for _ in range(7):
            x = x @ w
        return x

    want = _walker(scanned, (128, 128), (128, 128))
    assert want == 7 * 2 * 128 ** 3
    assert _counter(loop, (128, 128), (128, 128)) == want


def test_counter_nested_three_by_five():
    def nested(x, w):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ w, None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def loops(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    want = _walker(nested, (64, 64), (64, 64))
    assert want == 15 * 2 * 64 ** 3
    assert _counter(loops, (64, 64), (64, 64)) == want


def test_counter_counts_einsum_and_batched_products():
    """einsum and bmm reach the counter as the products they are."""
    def f(q, k):
        return torch.einsum("bsh,bth->bst", q, k)

    def g(q, k):
        return jnp.einsum("bsh,bth->bst", q, k)

    want = _walker(g, (2, 8, 16), (2, 12, 16))
    assert want == 2 * 2 * 8 * 12 * 16
    assert _counter(f, (2, 8, 16), (2, 12, 16)) == want
