"""Weights across the two packages: ``dasmtl_torch.models.weights``.

``state_dict_from_flax`` must be the exact inverse of the JAX package's
``port_two_level_state_dict`` (dasmtl/models/torch_port.py:97-144), strict
about every leaf, and ``init_fresh`` must draw the JAX fresh init's
distribution.  The Flax variable trees come from ``jax.eval_shape`` of the
JAX module's ``init`` (the real tree, with no compile) filled from a numpy
seed, with every BatchNorm statistic and affine moved off its init so a
mean/var or scale/bias swap cannot hide.  The other port test files import
:func:`random_flax_variables` from here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.models.torch_port import port_two_level_state_dict
from dasmtl.models.two_level import MTLNet as FlaxMTLNet
from dasmtl.models.two_level import SingleTaskNet as FlaxSingleTaskNet
from dasmtl_torch.models.two_level import MTLNet, SingleTaskNet, TwoLevelNet
from dasmtl_torch.models.weights import (conv_bn_state_dict, init_fresh,
                                         state_dict_from_flax)

FAMILIES = {
    "MTL": (FlaxMTLNet, MTLNet, ("distance", "event")),
    "single_distance": (lambda: FlaxSingleTaskNet("distance"),
                        lambda: SingleTaskNet("distance"), ("distance",)),
    "single_event": (lambda: FlaxSingleTaskNet("event"),
                     lambda: SingleTaskNet("event"), ("event",)),
}


def _fill(path, leaf, rng):
    name = str(getattr(path[-1], "key", path[-1]))
    shape = leaf.shape
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
    elif name == "scale":
        v = 1.0 + 0.2 * rng.normal(size=shape)
    elif name == "bias":
        v = 0.1 * rng.normal(size=shape)
    elif name == "mean":
        v = 0.1 * rng.normal(size=shape)
    elif name == "var":
        # Down to 1e-4 so BatchNorm's eps (1e-5) moves the result.
        v = rng.uniform(1e-4, 2.0, size=shape)
    else:
        raise KeyError(f"unexpected Flax leaf {name!r}")
    return np.asarray(v, np.float32)


def _as_dict(tree):
    if hasattr(tree, "items"):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


def random_flax_variables(module, seed: int, in_shape=(1, 52, 64, 1)):
    """``module``'s ``{"params", "batch_stats"}`` tree from ``eval_shape``
    of its eval-mode ``init``, every leaf drawn from ``seed``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(in_shape),
                            train=False))
    rng = np.random.default_rng(seed)
    filled = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _fill(p, leaf, rng), _as_dict(shapes))
    return {k: filled[k] for k in ("params", "batch_stats")}


def port_model(family: str, variables) -> torch.nn.Module:
    """The port's network of ``family`` carrying ``variables``."""
    _, build, tasks = FAMILIES[family]
    net = build()
    net.load_state_dict(state_dict_from_flax(variables, tasks), strict=True)
    return net.eval()


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_round_trip_through_port_two_level_state_dict_is_exact(family):
    """JAX variables -> the port's state dict -> a strict load -> the JAX
    package's own reverse conversion gives back the very same arrays."""
    flax_cls, _, tasks = FAMILIES[family]
    variables = random_flax_variables(flax_cls(), seed=3)
    net = port_model(family, variables)
    back = port_two_level_state_dict(net.state_dict(), tasks=tasks)
    want, got = _leaves(variables), _leaves(back)
    assert sorted(want) == sorted(got)
    for key, a in want.items():
        assert got[key].dtype == a.dtype == np.float32, key
        np.testing.assert_array_equal(got[key], a, err_msg=key)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_covers_the_port_module_exactly(family):
    flax_cls, build, tasks = FAMILIES[family]
    sd = state_dict_from_flax(random_flax_variables(flax_cls(), seed=4),
                              tasks)
    assert set(sd) == set(build().state_dict())


def test_reference_names_are_kept():
    """The port's modules carry the reference torch model's names, typo
    included, and OIHW conv kernels."""
    sd = state_dict_from_flax(random_flax_variables(FlaxMTLNet(), seed=5))
    for key in ("conv1.0.weight", "conv1.1.running_var",
                "resblock3.left.0.weight", "resblock3.left.4.bias",
                "resblock3.shortcut.0.weight", "att_mask_generato2.1.3.bias",
                "att_mask_generator4.0.0.weight", "output_layer3.1.1.weight"):
        assert key in sd, key
    assert "resblock2.shortcut.0.weight" not in sd  # identity shortcut
    assert tuple(sd["conv1.0.weight"].shape) == (16, 1, 7, 7)


def test_tasks_mismatch_raises():
    mtl = random_flax_variables(FlaxMTLNet(), seed=6)
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_flax(mtl, tasks=("distance",))
    single = random_flax_variables(FlaxSingleTaskNet("event"), seed=6)
    with pytest.raises(KeyError):
        state_dict_from_flax(single, tasks=("distance", "event"))


def test_missing_leaf_raises():
    variables = random_flax_variables(FlaxMTLNet(), seed=7)
    del variables["batch_stats"]["resblock3"]["conv_bn1"]["bn"]["var"]
    with pytest.raises(KeyError, match="resblock3/conv_bn1/bn/var"):
        state_dict_from_flax(variables)


def test_conv_bn_state_dict_is_strict():
    from dasmtl.models.layers import ConvBN as FlaxConvBN

    v = random_flax_variables(FlaxConvBN(4, (3, 3), use_bias=True), seed=8,
                              in_shape=(1, 6, 6, 2))
    sd = conv_bn_state_dict(v, prefix="m.")
    assert set(sd) == {"m.0.weight", "m.0.bias", "m.1.weight", "m.1.bias",
                       "m.1.running_mean", "m.1.running_var",
                       "m.1.num_batches_tracked"}
    v["params"]["extra"] = {"kernel": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        conv_bn_state_dict(v)


def test_init_fresh_is_seeded_and_resets_bn():
    a = init_fresh(TwoLevelNet(first_ch=8), seed=11).state_dict()
    b = init_fresh(TwoLevelNet(first_ch=8), seed=11).state_dict()
    c = init_fresh(TwoLevelNet(first_ch=8), seed=12).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["conv1.0.weight"], c["conv1.0.weight"])
    for k, v in a.items():
        if k.endswith(".bias") or k.endswith("running_mean"):
            assert torch.count_nonzero(v) == 0, k
        if k.endswith("running_var") or (k.endswith(".weight")
                                         and v.dim() == 1):
            assert torch.all(v == 1.0), k


def test_init_fresh_matches_flax_lecun_normal():
    """Same distribution as Flax's default conv init: a normal of std
    sqrt(1/fan_in) truncated to two of its pre-truncation stds."""
    net = init_fresh(MTLNet(), seed=0)
    w = net.resblock8.left[3].weight.detach().numpy()  # 128x128x3x3
    fan_in = 128 * 9
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (3, 3, 128, 128), jnp.float32))
    assert abs(w.std() / ref.std() - 1.0) < 0.02
    assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.02
    limit = 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
    assert np.abs(w).max() <= limit * (1 + 1e-6)
    assert np.abs(ref).max() <= limit * (1 + 1e-6)
    assert abs(float(w.mean())) < 0.01 / np.sqrt(fan_in) * 10
