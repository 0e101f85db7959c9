"""The port's checkpoint I/O (``checkpoint/io.py``) against the
reference's file format: a port-written f32 DiT tree with its AdamW state
loads with the reference's ``load``, a reference-written one loads in the
port, both bitwise, with the reference's leaf keys; bf16 leaves round-trip
bitwise in the port; a leaf-count or shape mismatch raises ``ValueError``
as in the reference; metadata round-trips.  (The reference cannot read its
own bf16 checkpoint back: ``np.savez`` stores an ml_dtypes leaf as
``|V2`` and ``load`` cannot cast it; ROADMAP, faults of the reference.
So the cross-package checks use f32 trees.)"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jload
from repro.checkpoint import load_metadata as jload_metadata
from repro.checkpoint import save as jsave
from repro.training.optimizer import AdamW as JAdamW
from repro_torch import bridge, tree
from repro_torch.checkpoint import load, load_metadata, save
from repro_torch.training import loop
from repro_torch.training.optimizer import AdamW
from tests.test_torch_model import jax_dit, port_dit
from tests.test_torch_transformer import jax_llm, port_llm

META = {"arch": "dit-smoke", "steps": 3,
        "history": [{"loss": 1.25, "step": 0}]}


@pytest.fixture(scope="module")
def dit():
    jcfg, jm, jp = jax_dit("smoke")
    model = port_dit(jcfg, jp)
    params = loop.param_tree(model)
    opt = AdamW()
    state = opt.init(params)
    g = torch.Generator().manual_seed(0)
    for leaf in tree.leaves(state.mu) + tree.leaves(state.nu):
        leaf.copy_(torch.rand(leaf.shape, generator=g))
    state = state._replace(step=7)
    return jm, jp, model, params, state


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.kind == "V" else a


def test_port_checkpoint_loads_in_the_reference(tmp_path, dit):
    jm, jp, model, params, state = dit
    path = str(tmp_path / "port.npz")
    save(path, {"params": params, "opt_state": state}, META)
    like = {"params": jp, "opt_state": JAdamW().init(jp)}
    got = jload(path, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    want = {"params": bridge.params_to_jax(model),
            "opt_state": bridge.state_to_jax(state)}
    for (path_, g), w in zip(tree.flatten_with_path(want),
                             jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(w), g,
                                      err_msg=tree.keystr(path_))
    assert int(got["opt_state"].step) == 7
    # the reference's keys for the same tree
    jsave(str(tmp_path / "ref.npz"), got, META)
    assert load_metadata(path)["keys"] == \
        jload_metadata(str(tmp_path / "ref.npz"))["keys"]


def test_reference_checkpoint_loads_in_the_port(tmp_path, dit):
    jm, jp, model, params, state = dit
    jstate = JAdamW().init(jp)
    jstate = jstate._replace(
        step=jnp.int32(5),
        mu=jax.tree.map(lambda a: a + 0.5, jstate.mu))
    path = str(tmp_path / "ref.npz")
    jsave(path, {"params": jp, "opt_state": jstate}, META)
    fresh = port_dit(jm.cfg, jax.tree.map(jnp.zeros_like, jp))
    fparams = loop.param_tree(fresh)
    like = {"params": fparams, "opt_state": AdamW().init(fparams)}
    got = load(path, like)
    assert got["opt_state"].step == 5
    for (p, g), w in zip(tree.flatten_with_path(got),
                         jax.tree.leaves({"params": jp,
                                          "opt_state": jstate})):
        assert isinstance(g, (torch.Tensor, int)), tree.keystr(p)
        np.testing.assert_array_equal(
            g.numpy() if isinstance(g, torch.Tensor) else g, np.asarray(w),
            err_msg=tree.keystr(p))
    for dst, src in zip(tree.leaves(fparams), tree.leaves(got["params"])):
        dst.copy_(src)
    np.testing.assert_array_equal(fresh.blocks[1].wq.detach().numpy(),
                                  np.asarray(jp["blocks"]["wq"][1]))
    assert load_metadata(path)["metadata"] == META


@pytest.mark.parametrize("family", ["dit", "llm"])
def test_bf16_round_trip_is_bitwise(tmp_path, family):
    if family == "dit":
        jcfg, _, jp = jax_dit("smoke", dtype="bfloat16")
        model = port_dit(jcfg, jp)
    else:
        _, _, jp = jax_llm("bfloat16")
        model = port_llm("bfloat16", jp)
    params = loop.param_tree(model)
    state = AdamW().init(params)
    path = str(tmp_path / "bf16.npz")
    save(path, {"params": params, "opt_state": state}, META)
    with np.load(path) as npz:
        descrs = {npz[k].dtype.str for k in npz.files}
    assert "|V2" in descrs
    like = tree.map(lambda x: torch.zeros_like(x) if isinstance(
        x, torch.Tensor) else 0, {"params": params, "opt_state": state})
    got = load(path, like)
    for (p, g), w in zip(tree.flatten_with_path(got),
                         tree.leaves({"params": params,
                                      "opt_state": state})):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype, tree.keystr(p)
            assert torch.equal(g.view(torch.int16) if g.dtype ==
                               torch.bfloat16 else g,
                               w.view(torch.int16) if w.dtype ==
                               torch.bfloat16 else w), tree.keystr(p)
        else:
            assert g == w
    # the reference's own bf16 tree, as np.savez stores it, reads bitwise
    jpath = str(tmp_path / "ref_bf16.npz")
    jsave(jpath, jp, META)
    got = load(jpath, params)
    for g, w in zip(tree.leaves(got), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(
            g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
            else g.numpy(),
            np.asarray(w).view(np.int16) if np.asarray(w).dtype.itemsize == 2
            else np.asarray(w))


def test_mismatches_raise_as_the_reference(tmp_path, dit):
    jm, jp, model, params, state = dit
    path = str(tmp_path / "p.npz")
    save(path, params)
    jpath = str(tmp_path / "j.npz")
    jsave(jpath, jp)
    fewer = dict(params)
    fewer.pop("t_b2")
    jfewer = dict(jp)
    jfewer.pop("t_b2")
    for fn, p, like in ((load, path, fewer), (jload, jpath, jfewer)):
        with pytest.raises(ValueError, match="holds 22 leaves; the target "
                                             "pytree expects 21"):
            fn(p, like)
    bad = dict(params, t_b2=torch.zeros(3))
    jbad = dict(jp, t_b2=jnp.zeros(3))
    for fn, p, like in ((load, path, bad), (jload, jpath, jbad)):
        with pytest.raises(ValueError, match=r"leaf 19: stored shape "
                                             r"\(128,\) != expected \(3,\)"):
            fn(p, like)


def test_metadata_round_trips(tmp_path, dit):
    _, jp, _, params, _ = dit
    path = str(tmp_path / "m")            # no suffix: .npz is added
    save(path, params, META)
    meta = load_metadata(path)
    assert meta["metadata"] == META
    assert meta["num_leaves"] == len(tree.leaves(params)) == 22
    assert meta["keys"][:2] == ["['blocks']['ada_b']", "['blocks']['ada_w']"]
    assert json.loads(json.dumps(meta)) == meta
    assert (tmp_path / "m.npz").exists() and (tmp_path / "m.meta.json").exists()
    got = load(str(tmp_path / "m.npz"), params)
    for g, w in zip(tree.leaves(got), tree.leaves(params)):
        assert torch.equal(g, w)


def test_tree_order_and_keys_are_jaxs():
    """Flatten order and key strings of nested dicts, NamedTuples and
    sequences are ``jax.tree_util``'s."""
    state = JAdamW().init({"b": jnp.zeros(2), "a": {"z": jnp.zeros(1)}})
    t = {"params": {"b": np.zeros(2), "a": {"z": np.zeros(1)}},
         "opt": state, "l": [np.zeros(1), (np.zeros(2), None)]}
    jpairs, _ = jax.tree_util.tree_flatten_with_path(t)
    pairs = tree.flatten_with_path(t)
    assert [tree.keystr(p) for p, _ in pairs] == \
        [jax.tree_util.keystr(p) for p, _ in jpairs]
    rebuilt = tree.unflatten(t, [np.ones(1)] * len(pairs))
    assert jax.tree.structure(rebuilt) == jax.tree.structure(t)


def test_reference_cannot_read_its_own_bf16_checkpoint(tmp_path):
    """The reference's fault the port does not mirror (ROADMAP): its
    ``load`` raises on the ``|V2`` leaves its ``save`` wrote for a bf16
    tree; the port reads the same file bitwise (above)."""
    _, _, jp = jax_dit("smoke", dtype="bfloat16")
    path = str(tmp_path / "ref_bf16.npz")
    jsave(path, jp)
    with pytest.raises(ValueError, match="No cast function"):
        jload(path, jp)


def test_moe_checkpoint_crosses_both_ways(tmp_path):
    """A reduced-arctic-480b f32 tree with its Adafactor state: the port's
    file loads in the reference with the reference's keys and bitwise
    leaves ((L, E, D, F) experts, (L, D, E) router, the factored moments
    (L, E, D) / (L, E, F)), and the reference's file loads in the port."""
    from repro.training.optimizer import Adafactor as JAdafactor
    from repro_torch.training.optimizer import Adafactor
    arch = "arctic-480b"
    _, jm, jp = jax_llm("float32", arch=arch)
    model = port_llm("float32", jp, arch)
    params = loop.param_tree(model)
    state = Adafactor().init(params)
    g = torch.Generator().manual_seed(1)
    for leaf in tree.leaves(state.vr) + tree.leaves(state.vc):
        leaf.copy_(torch.rand(leaf.shape, generator=g))
    state = state._replace(step=3)
    path = str(tmp_path / "moe.npz")
    save(path, {"params": params, "opt_state": state}, {"arch": arch})
    like = {"params": jp, "opt_state": JAdafactor().init(jp)}
    got = jload(path, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    want = {"params": bridge.params_to_jax(model),
            "opt_state": bridge.state_to_jax(state)}
    for (p, w), a in zip(tree.flatten_with_path(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), w,
                                      err_msg=tree.keystr(p))
    moe = got["params"]["blocks"]["pos0"]["moe"]
    assert moe["we_gate"].shape == (2, 4, 256, 512)
    assert moe["router"].shape == (2, 256, 4)
    assert got["opt_state"].vc["blocks"]["pos0"]["moe"]["we_down"].shape == (
        2, 4, 256)
    jsave(str(tmp_path / "ref.npz"), got, {"arch": arch})
    assert load_metadata(path)["keys"] == \
        jload_metadata(str(tmp_path / "ref.npz"))["keys"]
    fresh = port_llm("float32", jax.tree.map(jnp.zeros_like, jp), arch)
    fparams = loop.param_tree(fresh)
    back = load(str(tmp_path / "ref.npz"),
                {"params": fparams, "opt_state": Adafactor().init(fparams)})
    assert back["opt_state"].step == 3
    for (p, a), w in zip(tree.flatten_with_path(back),
                         jax.tree.leaves(got)):
        np.testing.assert_array_equal(
            a.numpy() if isinstance(a, torch.Tensor) else a, np.asarray(w),
            err_msg=tree.keystr(p))
