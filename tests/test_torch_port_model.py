"""The port's model A/B forward against the JAX package, on the CPU.

Each layer of ``dasmtl_torch.models.layers`` against its Flax counterpart
at narrow width (atol 1e-5), then whole networks — ``TwoLevelNet
(first_ch=8)`` and both single-task nets at (52, 64), ``MTLNet`` at the full
(100, 250) — against JAX ``apply(train=False)`` at the committed
cross-framework tolerance (atol 5e-4 / rtol 1e-4,
tests/test_torch_parity.py:76-77), decoded ints equal on rows whose top-2
margin exceeds 1e-3.  Weights go JAX tree -> numpy -> the port's state
dict, every BatchNorm statistic and affine off its init.  The JAX side runs
un-jitted at full size and jitted only at (52, 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.models import layers as flax_layers
from dasmtl.models.two_level import MTLNet as FlaxMTLNet
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl_torch.models import layers
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import conv_bn_state_dict, init_fresh
from dasmtl_torch.models.weights import state_dict_from_flax
from tests.test_torch_port_weights import (FAMILIES, port_model,
                                           random_flax_variables)

LAYER_ATOL = 1e-5
ATOL, RTOL = 5e-4, 1e-4  # tests/test_torch_parity.py:76-77
DECISIVE = 1e-3


def _nhwc(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _from_nchw(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _sub(variables, name):
    return {c: variables[c][name] for c in ("params", "batch_stats")}


def _flax_layer(module, seed, in_shape):
    v = random_flax_variables(module, seed, in_shape)
    x = _nhwc(seed + 100, in_shape)
    y = np.asarray(module.apply(v, jnp.asarray(x), train=False))
    return v, x, y


@pytest.mark.parametrize("bias,stride,kernel,pad", [
    (False, 1, 3, 1), (True, 1, 1, 0), (False, 3, 7, 2), (False, 2, 1, 0)])
def test_conv_bn(bias, stride, kernel, pad):
    module = flax_layers.ConvBN(6, (kernel, kernel), (stride, stride),
                                ((pad, pad), (pad, pad)), use_bias=bias)
    v, x, y = _flax_layer(module, 1, (2, 11, 13, 3))
    port = layers.ConvBN(3, 6, kernel, stride, pad, bias=bias)
    port.load_state_dict(conv_bn_state_dict(v), strict=True)
    with torch.no_grad():
        out = _from_nchw(port.eval()(_to_nchw(x)))
    np.testing.assert_allclose(out, y, atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("in_ch,out_ch,stride", [(4, 4, 1), (4, 8, 2)])
def test_res_block(in_ch, out_ch, stride):
    module = flax_layers.ResBlock(out_ch, stride)
    v, x, y = _flax_layer(module, 2, (2, 9, 11, in_ch))
    port = layers.ResBlock(in_ch, out_ch, stride)
    sd = {**conv_bn_state_dict(_sub(v, "conv_bn1"), "left.", "0", "1"),
          **conv_bn_state_dict(_sub(v, "conv_bn2"), "left.", "3", "4")}
    if "shortcut" in v["params"]:
        sd.update(conv_bn_state_dict(_sub(v, "shortcut"), "shortcut."))
    assert ("shortcut" in v["params"]) == (stride != 1 or in_ch != out_ch)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = _from_nchw(port.eval()(_to_nchw(x)))
    np.testing.assert_allclose(out, y, atol=LAYER_ATOL, rtol=0)


def test_attention_gate_carries_conv_biases():
    module = flax_layers.AttentionGate(4, 8)
    v, x, y = _flax_layer(module, 3, (2, 7, 9, 16))
    port = layers.AttentionGate(16, 4, 8)
    sd = {**conv_bn_state_dict(_sub(v, "reduce"), "", "0", "1"),
          **conv_bn_state_dict(_sub(v, "expand"), "", "3", "4")}
    assert "0.bias" in sd and "3.bias" in sd
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = _from_nchw(port.eval()(_to_nchw(x)))
    np.testing.assert_allclose(out, y, atol=LAYER_ATOL, rtol=0)


def test_output_layer():
    module = flax_layers.OutputLayer(8)
    v, x, y = _flax_layer(module, 4, (2, 7, 9, 4))
    port = layers.OutputLayer(4, 8)
    port.load_state_dict(conv_bn_state_dict(_sub(v, "conv_bn")), strict=True)
    with torch.no_grad():
        out = _from_nchw(port.eval()(_to_nchw(x)))
    np.testing.assert_allclose(out, y, atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(33, 83), (17, 42), (9, 21), (5, 11)])
def test_max_pool_ceil_is_flax_same_pool(hw):
    """ceil_mode=True equals Flax's SAME pool with a -inf pad, odd edges
    included; all-negative inputs would show a zero pad."""
    x = _nhwc(5, (2, *hw, 3)) - 10.0
    y = np.asarray(flax_layers.max_pool_ceil(jnp.asarray(x)))
    out = _from_nchw(layers.max_pool_ceil(_to_nchw(x)))
    assert out.shape == y.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 3)
    np.testing.assert_array_equal(out, y)


@pytest.mark.parametrize("classes", [16, 2])
def test_group_mean_head_groups_contiguous_channels(classes):
    x = _nhwc(6, (3, 5, 11, 128))
    y = np.asarray(flax_layers.group_mean_head(jnp.asarray(x), classes))
    out = layers.group_mean_head(_to_nchw(x), classes).numpy()
    np.testing.assert_allclose(out, y, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        layers.group_mean_head(_to_nchw(x), 3)


def test_backbone_channels():
    assert layers.backbone_channels(16, 8) == [16, 16, 32, 64, 128]
    assert layers.backbone_channels(8, 8) == \
        list(flax_layers.backbone_channels(8, 8))


def _assert_net_parity(net, x, flax_out):
    with torch.no_grad():
        outs = net(torch.from_numpy(x))
    assert len(outs) == len(flax_out)
    for o, f in zip(outs, flax_out):
        o, f = o.numpy(), np.asarray(f)
        np.testing.assert_allclose(o, f, atol=ATOL, rtol=RTOL)
        top2 = np.sort(f, axis=1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > DECISIVE
        assert decisive.any()
        np.testing.assert_array_equal(o.argmax(1)[decisive],
                                      f.argmax(1)[decisive])


def test_narrow_two_level_net_at_52x64():
    flax_model = FlaxTwoLevelNet(first_ch=8)
    variables = random_flax_variables(flax_model, seed=21)
    net = TwoLevelNet(first_ch=8)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    x = _nhwc(22, (3, 52, 64, 1))
    flax_out = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    _assert_net_parity(net.eval(), x, flax_out)


@pytest.mark.parametrize("family", ["single_distance", "single_event"])
def test_single_task_nets_at_52x64(family):
    flax_model = FAMILIES[family][0]()
    variables = random_flax_variables(flax_model, seed=23)
    x = _nhwc(24, (3, 52, 64, 1))
    flax_out = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    _assert_net_parity(port_model(family, variables), x, flax_out)


def test_mtl_net_full_width_at_100x250():
    """Model A at the full window and width, batch 2, un-jitted JAX."""
    flax_model = FlaxMTLNet()
    variables = random_flax_variables(flax_model, seed=25)
    x = _nhwc(26, (2, 100, 250, 1))
    flax_out = flax_model.apply(variables, jnp.asarray(x), train=False)
    _assert_net_parity(port_model("MTL", variables), x, flax_out)


@pytest.mark.parametrize("family,count", [("MTL", 1_136_224),
                                          ("single_distance", 918_376),
                                          ("single_event", 918_376)])
def test_parameter_counts(family, count):
    flax_cls, build, _ = FAMILIES[family]
    assert sum(p.numel() for p in build().parameters()) == count
    flax_params = random_flax_variables(flax_cls(), seed=0)["params"]
    assert sum(a.size for a in jax.tree.leaves(flax_params)) == count


def test_rows_are_independent():
    """A NaN window condemns only its own row: no op of the eval forward
    mixes rows."""
    net = init_fresh(TwoLevelNet(first_ch=8), seed=0).eval()
    x = _nhwc(27, (4, 52, 64, 1))
    poisoned = x.copy()
    poisoned[2, 10, 10, 0] = np.nan
    with torch.no_grad():
        clean = net(torch.from_numpy(x))
        dirty = net(torch.from_numpy(poisoned))
    for c, d in zip(clean, dirty):
        assert not torch.isfinite(d[2]).any()
        keep = [0, 1, 3]
        assert torch.equal(c[keep], d[keep])


def test_input_layout_is_nhwc_with_one_channel():
    net = TwoLevelNet(first_ch=8).eval()
    with torch.no_grad():
        outs = net(torch.zeros(2, 52, 64, 1))
        assert [tuple(o.shape) for o in outs] == [(2, 16), (2, 2)]
        with pytest.raises(ValueError, match="b, h, w, 1"):
            net(torch.zeros(2, 1, 52, 64))


def test_feature_map_schedule_at_100x250():
    """33x83 -> 17x42 -> 9x21 -> 5x11, the gate shapes of the kernel."""
    net = TwoLevelNet().eval()
    seen = []
    hooks = [getattr(net, f"resblock{i}").register_forward_hook(
        lambda m, i, o: seen.append(tuple(o.shape[1:]))) for i in (2, 4, 6, 8)]
    with torch.no_grad():
        net(torch.zeros(1, 100, 250, 1))
    for h in hooks:
        h.remove()
    assert seen == [(16, 33, 83), (32, 17, 42), (64, 9, 21), (128, 5, 11)]
