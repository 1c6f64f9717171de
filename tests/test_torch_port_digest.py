"""The port's leaf digest (``dasmtl_torch.ops.digest``) and state
fingerprints against the JAX package's ``leaf_digest`` and hashing layer,
on the CPU.

- ``leaf_digest_plain`` and ``digest_vector_plain`` equal JAX's
  ``leaf_digest`` bit for bit over f32, bf16, f16, int8 (negatives),
  uint8, int32, int64 (JAX under x64-off truncates it to int32, the port
  takes the low word: the same bits), bool, at sizes 0, 1, 3, 4097 and
  2^20+3, with NaN, -0.0 and +-Inf patterns; hypothesis drives values.
- The committed known answers (``KNOWN_ANSWERS``, which the card checks
  its kernel against) are JAX's digests.
- Leaf by leaf, a JAX model-A state carried across by
  ``state_dict_from_flax`` digests as JAX's does: biases and BatchNorm
  leaves as they stand, convolution weights after the permutation back to
  Flax's HWIO layout.
- ``named_leaves``, ``host_digest``, ``tree_digest`` and ``chain_digest``
  give JAX's strings on the same data.
- On the CPU ``digest_vector`` is the plain version and counts no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dasmtl.analysis.sanitize import fingerprint as jax_fp
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl_torch.analysis.sanitize import fingerprint as fp
from dasmtl_torch.models.weights import state_dict_from_flax
from dasmtl_torch.ops import digest
from tests.test_torch_port_weights import random_flax_variables

SIZES = (0, 1, 3, 4097, 2 ** 20 + 3)
DTYPES = ("float32", "bfloat16", "float16", "int8", "uint8", "int32",
          "int64", "bool")


def _operand(dtype, n, seed):
    """(numpy for JAX, torch for the port) with the same bits."""
    rng = np.random.default_rng(seed)
    if dtype in ("int8", "uint8", "int32", "int64"):
        info = np.iinfo(dtype)
        a = rng.integers(max(info.min, -2 ** 40), min(info.max, 2 ** 40),
                         n, endpoint=True).astype(dtype)
        return a, torch.from_numpy(a)
    if dtype == "bool":
        a = rng.integers(0, 2, n).astype(np.bool_)
        return a, torch.from_numpy(a)
    x = (rng.normal(size=n) * 1e3).astype(np.float32)
    specials = np.asarray([np.nan, -0.0, np.inf, -np.inf], np.float32)
    x[:min(n, 4)] = specials[:min(n, 4)]
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return t.view(torch.int16).numpy().view(jnp.bfloat16), t
    a = x.astype(dtype)
    return a, torch.from_numpy(a)


def _jax_digest(a):
    with np.errstate(over="ignore"):
        return int(jax_fp.leaf_digest(jnp.asarray(a)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_digest_matches_jax_over_dtypes_and_sizes(dtype):
    ours, want = [], []
    for i, n in enumerate(SIZES):
        a, t = _operand(dtype, n, seed=7 * i + len(dtype))
        assert int(digest.leaf_digest_plain(t)) == _jax_digest(a), (dtype, n)
        ours.append(t)
        want.append(_jax_digest(a))
    vec = digest.as_uint32(digest.digest_vector_plain(ours))
    assert vec.tolist() == want


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True),
                min_size=0, max_size=64),
       st.lists(st.integers(-128, 127), min_size=0, max_size=64))
def test_plain_digest_matches_jax_on_drawn_values(floats, ints):
    f = np.asarray(floats, np.float32)
    i8 = np.asarray(ints, np.int8)
    assert int(digest.leaf_digest_plain(torch.from_numpy(f))) == \
        _jax_digest(f)
    assert int(digest.leaf_digest_plain(torch.from_numpy(i8))) == \
        _jax_digest(i8)


def test_known_answers_are_jax_digests():
    inputs = digest.known_answer_inputs()
    assert set(inputs) == set(digest.KNOWN_ANSWERS)
    for name, a in inputs.items():
        ja = a.view(jnp.bfloat16) if name.startswith("bf16_bits") else a
        assert _jax_digest(ja) == digest.KNOWN_ANSWERS[name], name
        t = digest.known_answer_tensor(name, a)
        assert int(digest.leaf_digest_plain(t)) == \
            digest.KNOWN_ANSWERS[name], name


def test_digest_vector_on_the_cpu_is_the_plain_version():
    digest.launches.reset()
    leaves = [torch.randn(5), torch.arange(7, dtype=torch.int64),
              torch.zeros(0), torch.tensor(True)]
    got = digest.digest_vector(leaves)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert torch.equal(got, digest.digest_vector_plain(leaves))
    assert [int(digest.leaf_digest_plain(t)) for t in leaves] == \
        digest.as_uint32(got).tolist()
    assert digest.launches.value == 0
    with pytest.raises(TypeError):
        digest.digest_vector([torch.zeros(2, dtype=torch.complex64)])


def test_model_a_state_digests_leaf_by_leaf_as_jax():
    """A full-width model-A JAX state carried across: every port leaf's
    digest (conv weights permuted back to HWIO) is the digest JAX gives
    the same Flax leaf, and the two sets match one to one."""
    flax_model = FlaxTwoLevelNet()
    variables = random_flax_variables(flax_model, 71)
    jax_leaves = jax_fp.named_leaves(variables)
    want = np.asarray(jax.device_get(jax_fp.digest_vector(
        [leaf for _, leaf in jax_leaves])))
    by_shape = {}
    for (name, leaf), d in zip(jax_leaves, want.tolist()):
        by_shape.setdefault(np.asarray(leaf).shape, set()).add(d)
    sd = state_dict_from_flax(variables)
    ours = {k: (v.permute(2, 3, 1, 0).contiguous() if v.dim() == 4 else v)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    got = digest.as_uint32(digest.digest_vector(list(ours.values())))
    for (k, t), d in zip(ours.items(), got.tolist()):
        assert d in by_shape[tuple(t.shape)], f"{k}: {d:#010x} is no JAX " \
            f"digest of a {tuple(t.shape)} leaf"
    assert sorted(got.tolist()) == sorted(want.tolist())
    assert len(ours) == len(jax_leaves)


def test_host_hashes_are_jax_strings():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": np.arange(5, dtype=np.int32)}}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    assert [n for n, _ in fp.named_leaves(ttree)] == \
        [n for n, _ in jax_fp.named_leaves(tree)]
    assert fp.tree_digest(ttree) == jax_fp.tree_digest(tree)
    assert fp.host_digest(ttree["a"]) == jax_fp.host_digest(tree["a"])
    rec = {"loss_sum": 1.25, "count": 8.0, "correct_event": 3.0}
    assert fp.chain_digest("cell", rec) == jax_fp.chain_digest("cell", rec)
