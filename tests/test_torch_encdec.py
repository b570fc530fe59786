"""Port parity: the encoder-decoder family (seamless-m4t-large-v2: an
encoder over stub frame embeddings, cross-attention in every decoder
block) and the vision-patch input (internvl2-1b) of ``repro_torch`` against
the JAX package, on shared weights at smoke size (d_model 64, 4 heads,
2 + 2 layers and 16 frames; 8 patches).

Tolerances, in f32: outputs and logits within rtol = atol = 1e-4 (XLA's
CPU matmuls and torch's sum in another order); the loss within 1e-5
relative and every gradient leaf within rtol 1e-4 and an atol of 1e-4
times the leaf's largest reference value (``test_torch_moe.py``'s rule).
The model-level forward, prefill, cache and decode cases are in
``test_torch_models.py`` (``test_encdec_and_vlm_families_match``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.configs import get_config as tget
from repro_torch.device import cap_test_threads
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as ttr
from repro_torch.training import tree as tree_lib
from test_torch_models import _pair, family_batch
from test_torch_moe import GRAD_TOL, LOSS_RTOL, _jax_flat, _torch_tree

cap_test_threads()

TOL = dict(rtol=1e-4, atol=1e-4)
SEAMLESS = "seamless-m4t-large-v2"
INTERNVL = "internvl2-1b"


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.fixture(scope="module")
def seamless():
    return _pair(SEAMLESS)


def test_encode_matches(seamless):
    """The encoder alone: per layer bidirectional attention in the cross
    form (no RoPE, no mask), the MLP, then ``enc_norm``."""
    cfg, _, jp, tm, tp = seamless
    frames = family_batch(cfg, np.random.RandomState(4), 2, 4)["frames"]
    want = jax.jit(jtr.encode, static_argnums=1)(jp, cfg,
                                                  jnp.asarray(frames))
    got = ttr.encode(tp, tm.cfg, torch.from_numpy(frames))
    assert got.shape == (2, cfg.n_frames, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", [SEAMLESS, "deepseek-v2-lite-16b",
                                  "qwen3-1.7b"])
def test_cross_attention_layer_matches(arch):
    """``attention_fwd`` with ``kv_source``, K/V computed from it and then
    read back from a cache holding them: an MLA config takes the GQA form
    (its cross params are GQA-shaped), a qk-norm config normalizes q only,
    and neither applies RoPE (the positions change nothing)."""
    cfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jp = jattn.init_attention(jax.random.key(1), cfg, jnp.float32,
                              cross=True)
    assert sorted(jp) == sorted(tattn.param_shapes(tcfg, cross=True))
    tp = _torch_tree(jp)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, cfg.d_model).astype(np.float32)
    mem = rng.randn(2, 10, cfg.d_model).astype(np.float32)
    pos = rng.randint(0, 100, (2, 6))
    jo, jc = jattn.attention_fwd(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                 kv_source=jnp.asarray(mem))
    to, tc = tattn.attention_fwd(tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos),
                                 kv_source=torch.from_numpy(mem))
    _close(to, jo)
    for name in ("k", "v"):
        assert tc[name].shape == (2, 10, tcfg.n_kv_heads,
                                  tcfg.resolved_head_dim)
        _close(tc[name], jc[name])
    moved, _ = tattn.attention_fwd(tp, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(pos + 7),
                                   kv_source=torch.from_numpy(mem))
    assert torch.equal(moved, to)
    cached, _ = tattn.attention_fwd(tp, tcfg, torch.from_numpy(x[:, :1]),
                                    torch.from_numpy(pos[:, :1]), cache=tc,
                                    kv_source=torch.zeros(2, 1, cfg.d_model))
    _close(cached, jo[:, :1])


def _loss_batch(cfg, seed: int = 3) -> dict:
    """A training batch: tokens (4, 24), frames or patches, and labels over
    the patches and the tokens, the patches' labels ignored (-1)."""
    rng = np.random.RandomState(seed)
    batch = family_batch(cfg, rng, 4, 24)
    n = 24 + (cfg.n_patches or 0)
    labels = rng.randint(0, cfg.vocab_size, (4, n))
    labels[:, :cfg.n_patches or 0] = -1
    batch["labels"] = labels
    return batch


@pytest.mark.parametrize("arch,remat", [(SEAMLESS, False), (SEAMLESS, True),
                                        (INTERNVL, False)],
                         ids=["seamless", "seamless-remat", "internvl"])
def test_loss_and_grads_match(arch, remat):
    """``Model.loss`` and its autograd gradients against
    ``jax.value_and_grad`` of the reference's, every leaf: the encoder's
    stack and norm, each block's ``cross`` and ``ln_cross``, the patch
    projection. Remat checkpoints the decoder groups, the encoder's output
    passing into them."""
    cfg, jm, jp, tm, tp = _pair(arch)
    batch = _loss_batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat)))(jp)
    leaves = [x.detach().requires_grad_() for x in tree_lib.leaves(tp)]
    tl = tm.loss(tree_lib.unflatten(tp, leaves),
                 {k: torch.from_numpy(v) for k, v in batch.items()},
                 remat=remat)
    grads = torch.autograd.grad(tl, leaves)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    want = _jax_flat(jg)
    got = dict(zip(("/".join(p) for p, _ in tree_lib.flatten_with_paths(tp)),
                   grads))
    assert sorted(got) == sorted(want)
    if cfg.is_encoder_decoder:
        assert {"enc_norm", "enc_stack/attn/wq", "stack/0/cross/wk",
                "stack/0/ln_cross"} <= set(got)
    else:
        assert "patch_proj" in got
    for key, g in got.items():
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=key)


def test_batch_without_patches_is_the_text_model():
    """internvl with no ``patch_embeds`` in the batch computes what the
    same weights compute as a text-only config (no patches, no
    ``patch_proj``): forward logits, prefill and a decode step at slot S,
    bit for bit."""
    cfg, _, _, tm, tp = _pair(INTERNVL)
    text = tbuild(dataclasses.replace(tm.cfg, n_patches=0))
    tp_text = {k: v for k, v in tp.items() if k != "patch_proj"}
    assert "patch_proj" not in ttr.param_shapes(text.cfg)
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        assert torch.equal(tm.forward(tp, {"tokens": toks}),
                           text.forward(tp_text, {"tokens": toks}))
    got = tm.prefill(tp, {"tokens": toks[:, :11]}, capacity=16)
    want = text.prefill(tp_text, {"tokens": toks[:, :11]}, capacity=16)
    assert torch.equal(got[0], want[0])
    a, _ = tm.decode_step(tp, got[1], 11, toks[:, 11:])
    b, _ = text.decode_step(tp_text, want[1], 11, toks[:, 11:])
    assert torch.equal(a, b)


def test_missing_frames_raise_keyerror(seamless):
    """An encoder-decoder batch without ``frames`` raises the KeyError the
    reference's does: in the loss, the forward and the prefill."""
    cfg, jm, jp, tm, tp = seamless
    toks = np.zeros((1, 8), np.int64)
    with pytest.raises(KeyError, match="frames"):
        jm.loss(jp, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    for call in (lambda: tm.loss(tp, batch), lambda: tm.forward(tp, batch),
                 lambda: tm.prefill(tp, batch, capacity=16)):
        with pytest.raises(KeyError, match="frames"):
            call()


def test_init_follows_the_reference_scheme():
    """The port's seeded init of the new leaves: ``ln_cross`` and
    ``enc_norm`` ones, every matrix (the cross and encoder projections,
    ``patch_proj``) N(0, 1/d_in)."""
    for arch in (SEAMLESS, INTERNVL):
        m = tbuild(tget(arch, smoke=True))
        p = m.init(0, "cpu")
        flat = dict(("/".join(k), v) for k, v in
                    tree_lib.flatten_with_paths(p))
        norms = [k for k in flat if k.split("/")[-1] in ("ln_cross",
                                                         "enc_norm")]
        mats = [k for k in flat if k.split("/")[-1] in ("wq", "wk", "wo",
                                                        "patch_proj")
                and ("cross" in k or "enc" in k or k == "patch_proj")]
        assert (len(norms) > 0) == m.cfg.is_encoder_decoder
        for k in norms:
            assert torch.equal(flat[k], torch.ones_like(flat[k])), k
        assert mats
        for k in mats:
            w = flat[k]
            assert abs(float(w.std()) * w.shape[-2] ** 0.5 - 1) < 0.15, k


def test_text_train_step_matches_with_patch_proj_unreached():
    """internvl trains on text batches in both serve drivers: the patch
    projection is then in no path to the loss. ``jax.grad`` gives it zero
    gradients and the port's train step does too, so both packages' two
    steps agree: loss, grad norm and every leaf, ``patch_proj`` (weight
    decay alone moves it) included."""
    from repro.training import optimizer as jopt
    from repro.training import train_step as jts
    from repro.training.data import Pipeline, PipelineConfig
    from repro_torch.launch import serve as tserve
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train_step import TrainState, make_train_step

    cfg, jm, jp, tm, tp = _pair(INTERNVL)
    # the serve driver's schedule, in each package
    jcfg = jopt.AdamWConfig(lr=jopt.wsd_schedule(3e-3, 15, 75, 50))
    tcfg = tserve.smoke_opt_config(150)
    jstate = jts.TrainState(jp, jopt.adamw_init(jcfg, jp))
    jstep = jax.jit(jts.make_train_step(jm, jcfg))
    tstate = TrainState(tp, topt.adamw_init(tcfg, tp))
    tstep = make_train_step(tm, tcfg)
    pipe = Pipeline(PipelineConfig(cfg.vocab_size, 96, 4, kind="recall"))
    for _ in range(2):
        b = pipe.next_batch()
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        tstate, tmet = tstep(tstate, {k: torch.as_tensor(v, dtype=torch.long)
                                      for k, v in b.items()})
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=LOSS_RTOL)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4)
    want = _jax_flat(jstate.params)
    assert not np.array_equal(np.asarray(want["patch_proj"]),
                              np.asarray(jp["patch_proj"]))
    for path, leaf in tree_lib.flatten_with_paths(tstate.params):
        _close(leaf, want["/".join(path)])
