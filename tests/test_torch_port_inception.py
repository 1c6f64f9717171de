"""Model C (``dasmtl_torch.models.inception``) against the JAX package, on
the CPU, at 75x75 (the smallest window the network takes), 8 windows
(every 3rd NaN-poisoned).

- The parameter count (21,850,560), the weight bridge (the inverse of
  ``dasmtl/models/torch_port.py:190-240 port_inception_state_dict``,
  strict, ``AuxLogits`` included) and the fresh init's distribution.
- The f32 serve forward with JAX's fresh-init weights carried across, at
  the committed cross-framework tolerance (atol 5e-4 / rtol 1e-4,
  tests/test_torch_parity.py:76-77), and its mixed decode.
- The bf16 and int8 serve forwards against JAX's ``precision_forward`` at
  the preset tolerances (0.05, 0.10), with weights drawn with numpy at He
  scale (``init_scaled``).  Fresh init cannot serve there: model C draws
  every conv from a truncated normal(0.1) with no fan-in scaling
  (``inception.py:28-29``), and through ~95 conv layers with unit
  BatchNorm statistics its logits reach ~1e5, where any rounding moves
  the log-probs by thousands.
- At fresh init both packages give the same parity verdict: failing, the
  NaN mask differing under int8.  The reference's ``int8_dot`` turns a NaN
  window finite (its row max is NaN, so ``xscale = 1`` and NaN quantizes
  to 0), so JAX's int8 model C never flags a NaN window in ``bad_rows``;
  the port reproduces that.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.export import make_serve_infer_fn as jax_serve_infer_fn
from dasmtl.models import precision as P
from dasmtl.models.inception import InceptionAux as FlaxAux
from dasmtl.models.inception import InceptionV3Classifier as FlaxInception
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import port_inception_state_dict
from dasmtl_torch.export import make_serve_infer_fn
from dasmtl_torch.models import precision as TP
from dasmtl_torch.models.inception import InceptionV3Classifier
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import (inception_state_dict_from_flax,
                                         init_fresh, init_scaled)
from dasmtl_torch.serve import parity
from dasmtl_torch.serve.executor import InferExecutor
from tests.test_torch_port_precision import (TOLERANCES, port_preset_run,
                                             split_outputs)
from tests.test_torch_port_weights import random_flax_variables

HW = (75, 75)
ATOL, RTOL = 5e-4, 1e-4  # tests/test_torch_parity.py:76-77
FAMILY = "multi_classifier"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes gain nothing from intra-op threads, and the suite runs
    several test processes on one host: one thread each keeps them from
    starving one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, {
        k: dict(variables[k]) for k in ("params", "batch_stats")})


@pytest.fixture(scope="module")
def windows():
    w, poisoned = parity.seeded_windows(8, HW, poison_every=3)
    return w[..., None], poisoned


@pytest.fixture(scope="module")
def jax_fresh():
    """JAX's own fresh init of model C (seed 1, ``Config.seed``)."""
    module = FlaxInception(num_classes=32)
    init = jax.jit(lambda k: module.init(k, jnp.zeros((1, *HW, 1)),
                                         train=False))
    return _tree(init(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def jax_forwards():
    """JAX's ``precision_forward`` of model C per preset, jitted once."""
    spec = jax_model_spec(FAMILY)
    return {p: jax.jit(P.precision_forward(spec, p))
            for p in ("f32", "bf16", "int8")}


def _jax_run(jax_forwards, variables, precision, x):
    pack = P.precision_variables(variables, precision)
    return split_outputs(jax.device_get(jax_forwards[precision](pack, x)))


# -- structure and weights ----------------------------------------------------
def test_parameter_count():
    net = InceptionV3Classifier()
    assert sum(p.numel() for p in net.parameters()) == 21_850_560
    aux = InceptionV3Classifier(aux_logits=True)
    shapes = jax.eval_shape(lambda: FlaxInception(aux_logits=True).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 299, 299, 1)), train=True))
    want = sum(int(np.prod(p.shape))
               for p in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in aux.parameters()) == want


def _aux_variables(seed):
    module = FlaxInception(aux_logits=True)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 299, 299, 1)), train=True))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        return rng.normal(size=leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, {k: dict(shapes[k]) for k in ("params", "batch_stats")})


@pytest.mark.parametrize("aux", [False, True])
def test_state_dict_bridge_inverts_port_inception_state_dict(aux):
    variables = (_aux_variables(4) if aux else
                 random_flax_variables(FlaxInception(), 4, (1, *HW, 1)))
    sd = inception_state_dict_from_flax(variables)
    net = InceptionV3Classifier(aux_logits=aux)
    net.load_state_dict(sd, strict=True)
    back = port_inception_state_dict(net.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
    again = inception_state_dict_from_flax(back)
    assert sorted(again) == sorted(net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(again[k], v), k


def test_state_dict_bridge_is_strict():
    variables = random_flax_variables(FlaxInception(), 5, (1, *HW, 1))
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["params"]["Mixed_6c"]["branch7x7dbl_3"]
    with pytest.raises(KeyError, match="Mixed_6c/branch7x7dbl_3"):
        inception_state_dict_from_flax(missing)
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["Mixed_9z"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="Mixed_9z"):
        inception_state_dict_from_flax(extra)


def test_fresh_init_draws_the_jax_distribution():
    """Every conv and ``fc`` from a normal(0.1) cut at +-0.2 (std about
    0.088 after the cut), no fan-in scaling; the aux ``fc`` at std 0.001;
    zero ``fc`` biases; BatchNorm at identity."""
    a = init_fresh(InceptionV3Classifier(aux_logits=True), 3)
    convs = torch.cat([m.weight.flatten() for m in a.modules()
                       if isinstance(m, torch.nn.Conv2d)])
    assert convs.abs().max() <= 0.2
    assert abs(convs.std().item() - 0.0880) < 0.001
    assert a.fc.weight.abs().max() <= 0.2 and not a.fc.bias.any()
    aux_fc = a.AuxLogits.fc.weight
    assert aux_fc.abs().max() <= 0.002 and aux_fc.std() < 0.001
    bn = a.Mixed_5b.branch1x1.bn
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert not bn.bias.any() and not bn.running_mean.any()


def test_aux_head_matches_flax():
    """The aux head in eval mode at its viable 17x17 Mixed_6e map."""
    variables = _aux_variables(6)
    for leaf in jax.tree_util.tree_leaves(variables["batch_stats"]):
        leaf[...] = np.abs(leaf) + 0.5  # positive running variances
    net = InceptionV3Classifier(aux_logits=True)
    net.load_state_dict(inception_state_dict_from_flax(variables))
    x = np.random.default_rng(7).normal(size=(2, 17, 17, 768)).astype(
        np.float32)
    sub = {k: variables[k]["AuxLogits"] for k in ("params", "batch_stats")}
    want = np.asarray(FlaxAux(num_classes=32).apply(sub, x, train=False))
    with torch.no_grad():
        got = net.AuxLogits.eval()(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_mixed_decode_matches_jax():
    logits = np.random.default_rng(8).normal(size=(64, 32)).astype(
        np.float32)
    want = jax_model_spec(FAMILY).decode((jnp.asarray(logits),))
    got = get_model_spec(FAMILY).decode([torch.from_numpy(logits)])
    assert list(got) == ["mixed", "distance", "event"]
    for task in got:
        assert got[task].dtype == torch.int32
        np.testing.assert_array_equal(got[task].numpy(), np.asarray(
            want[task]))


# -- the serve forwards against JAX -------------------------------------------
def test_f32_serve_forward_matches_jax(jax_fresh, windows):
    x, poisoned = windows
    module = FlaxInception(num_classes=32)
    state = types.SimpleNamespace(apply_fn=module.apply,
                                  params=jax_fresh["params"],
                                  batch_stats=jax_fresh["batch_stats"])
    want = split_outputs(jax.device_get(jax.jit(jax_serve_infer_fn(
        jax_model_spec(FAMILY), state))(x)))
    net = InceptionV3Classifier()
    net.load_state_dict(inception_state_dict_from_flax(jax_fresh),
                        strict=True)
    got = split_outputs({k: v.numpy() for k, v in make_serve_infer_fn(
        get_model_spec(FAMILY), net)(torch.from_numpy(x)).items()})
    np.testing.assert_array_equal(got[1], poisoned)
    np.testing.assert_array_equal(want[1], poisoned)
    clean = ~poisoned
    np.testing.assert_allclose(got[2]["log_probs_0"][clean],
                               want[2]["log_probs_0"][clean], atol=ATOL,
                               rtol=RTOL)
    assert list(got[0]) == ["mixed", "distance", "event"]
    for task in got[0]:
        np.testing.assert_array_equal(got[0][task][clean],
                                      want[0][task][clean])


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_preset_serve_fn_matches_jax(jax_forwards, windows, precision):
    x, poisoned = windows
    sd = init_scaled(InceptionV3Classifier(), 9).state_dict()
    want = _jax_run(jax_forwards, port_inception_state_dict(sd), precision,
                    x)
    got, meta = port_preset_run(FAMILY, sd, precision, x)
    # Under int8 neither package rejects the NaN windows (see the module
    # docstring), so the comparison takes no poisoned set.
    verdict = parity.compare_runs(want, got, np.zeros_like(poisoned),
                                  precision=precision)
    assert verdict["failures"] == []
    assert verdict["log_prob_max_abs_diff"] <= TOLERANCES[precision]
    np.testing.assert_array_equal(got[1], want[1])
    assert meta.n_dense_native == (1 if precision == "int8" else 0)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_fresh_init_parity_verdict_matches_jax(jax_fresh, jax_forwards,
                                               windows, precision):
    """At fresh init both packages fail the gate; under int8 both with
    the NaN mask differing."""
    x, poisoned = windows
    ref = _jax_run(jax_forwards, jax_fresh, "f32", x)
    jax_verdict = parity.compare_runs(
        ref, _jax_run(jax_forwards, jax_fresh, precision, x), poisoned,
        precision=precision)
    report = parity.run_parity(precision, model=FAMILY, input_hw=HW,
                               n_windows=24, batch=8, poison_every=3,
                               device="cpu")
    assert jax_verdict["failures"] and not report.passed
    assert report.log_prob_max_abs_diff > report.log_prob_tolerance
    assert jax_verdict["log_prob_max_abs_diff"] > \
        jax_verdict["log_prob_tolerance"]
    want_mask = precision != "int8"
    assert jax_verdict["nan_mask_identical"] is want_mask
    assert report.nan_mask_identical is want_mask


def test_int8_keeps_nan_windows_as_jax_does(jax_fresh, jax_forwards,
                                            windows):
    """The reference's int8 model C answers a NaN window (``bad_rows``
    False), where f32 rejects it; the port with the same weights too."""
    x, poisoned = windows
    want = _jax_run(jax_forwards, jax_fresh, "int8", x)
    got, _ = port_preset_run(FAMILY, inception_state_dict_from_flax(
        jax_fresh), "int8", x)
    assert not want[1].any() and not got[1].any()
    assert np.isfinite(got[2]["log_probs_0"][poisoned]).all()


def test_executor_serves_model_c_int8():
    ex = InferExecutor.from_fresh_init(FAMILY, (2,), HW, 0,
                                       torch.device("cpu"), "int8")
    x, _ = parity.seeded_windows(2, HW, poison_every=0)
    preds, bad = ex.run(x[..., None])
    assert list(preds) == ["mixed", "distance", "event"]
    np.testing.assert_array_equal(preds["distance"], preds["mixed"] % 16)
    np.testing.assert_array_equal(preds["event"], preds["mixed"] // 16)
    assert not bad.any()
    meta = ex.compile_summary()["precision_meta"]
    assert meta["n_dense_native"] == 1 and meta["n_kernels_quantized"] == 95


def test_int8_fc_is_the_int8_dot_layer():
    net = InceptionV3Classifier()
    TP.apply_precision(net, "int8")
    assert isinstance(net.fc, TP.Int8Linear)
    assert net.fc.q.dtype == torch.int8 and tuple(net.fc.q.shape) == (32,
                                                                       2048)
    assert net.fc.bias.dtype == torch.bfloat16


def test_eval_batchnorm_keeps_its_factor_until_the_state_moves():
    """The eval BatchNorm's ``rsqrt(var + eps) * scale`` is made once and
    reused while no gradient is wanted; a new state (load_state_dict, an
    in-place write) makes it again, and a forward that wants gradients
    still reaches the scale."""
    from dasmtl_torch.models.inception import FlaxEvalBatchNorm2d

    def flax(bn, x):
        inv = torch.rsqrt((bn.running_var + bn.eps).double()).float()
        return ((x - bn.running_mean.view(1, -1, 1, 1))
                * (inv * bn.weight).view(1, -1, 1, 1)
                + bn.bias.view(1, -1, 1, 1)).detach()

    bn = FlaxEvalBatchNorm2d(4, eps=1e-3).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 4, 3, 3)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(bn(x), flax(bn, x))
    factor = bn._factor[1]
    assert not factor.is_inference()
    with torch.no_grad():
        assert torch.equal(bn(x), flax(bn, x))
    assert bn._factor[1] is factor
    bn.load_state_dict({**bn.state_dict(),
                        "running_var": torch.full((4,), 4.0),
                        "weight": torch.full((4,), 2.0)})
    with torch.no_grad():
        assert torch.equal(bn(x), flax(bn, x))
        assert bn._factor[1] is not factor
        bn.running_var.fill_(9.0)
        assert torch.equal(bn(x), flax(bn, x))
    bn(x.requires_grad_()).sum().backward()
    assert bn.weight.grad is not None
