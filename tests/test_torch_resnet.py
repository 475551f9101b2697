"""The port's ResNet (horovod_tpu_torch/models/resnet.py) against the Flax
model of the reference, on the same parameters via models/convert.py.

Reduced width (8 filters, 10 classes) at 32x32. In float64 (the test
platform enables x64) the two models must agree to the final float32 cast
of the logits and running statistics (rtol 1e-6) -- this is the check of
the structure. In float32 the logits must agree to atol 5e-3 and the
running statistics to 1e-3 of each tensor's largest entry: XLA and oneDNN
sum a convolution in different orders, and each BatchNorm of the 17
(ResNet-50) in series rescales that last-bit noise by the inverse standard
deviation of a batch of 4 (measured: 3.3e-3 on logits of magnitude ~2, and
1.4e-5 on a running mean of magnitude 0.12 in the fifteenth block).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.convert import resnet_state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch ops
    from taking every core from the timing-sensitive tests beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _flax_model(name, dtype=jnp.float32):
    """(Flax model, perturbed params, batch stats) as numpy trees; cached
    per module, callers only read them."""
    model = getattr(ref_resnet, name)(num_filters=8, num_classes=10,
                                      dtype=dtype)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 32, 3), jnp.float32), train=True)
    params = _to_numpy(variables["params"])
    # random BN scales and biases, so the zero-initialised last BN of each
    # block does not hide its branch from the comparison
    rng = np.random.RandomState(3)

    def perturb(path, leaf):
        key = path[-1].key
        if key == "scale":
            return (1 + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if key == "bias":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return model, params, _to_numpy(variables["batch_stats"])


def _torch_model(name, params, batch_stats, dtype=torch.float32):
    net = getattr(resnet, name)(num_filters=8, num_classes=10)
    net.load_state_dict(resnet_state_dict_from_flax(params, batch_stats),
                        strict=True)
    return net.to(dtype)


def _images(n=4, dtype=np.float32):
    return np.random.RandomState(0).randn(n, 32, 32, 3).astype(dtype)


# (jax dtype, torch dtype, numpy dtype, logits rtol, logits atol, stats rtol)
PRECISIONS = {
    "float64": (jnp.float64, torch.float64, np.float64, 1e-6, 1e-6, 1e-6),
    "float32": (jnp.float32, torch.float32, np.float32, 0.0, 5e-3, 1e-3),
}


@pytest.mark.parametrize("name", ["ResNet50", "ResNet18"])
def test_converted_state_dict_covers_the_model(name):
    model, params, stats = _flax_model(name)
    sd = resnet_state_dict_from_flax(params, stats)
    net = getattr(resnet, name)(num_filters=8, num_classes=10)
    ref_sd = net.state_dict()
    assert sorted(sd) == sorted(ref_sd)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref_sd[k].shape), k
    n_flax = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in net.parameters())
    # the last BN scale of every block starts at zero in both models
    last = "bn2" if name == "ResNet50" else "bn1"
    zero = [k for k in ref_sd if k.endswith(f"{last}.weight")]
    assert zero and all(not ref_sd[k].any() for k in zero)


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("name", ["ResNet50", "ResNet18"])
def test_train_mode_logits_and_running_stats(name, precision):
    jdt, tdt, ndt, rtol, atol, stats_rtol = PRECISIONS[precision]
    model, params, stats = _flax_model(name, jdt)
    x = _images(dtype=ndt)
    logits, new_state = model.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    net = _torch_model(name, params, stats, tdt).train()
    out = net(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               rtol=rtol, atol=atol)
    expect = resnet_state_dict_from_flax(params, _to_numpy(
        new_state["batch_stats"]))
    got = net.state_dict()
    checked = 0
    for k in expect:
        if k.endswith(("running_mean", "running_var")):
            # relative to the tensor's scale: a running mean near zero
            # carries the absolute noise of the activations it averages
            ref = expect[k].numpy()
            np.testing.assert_allclose(
                got[k].float().numpy(), ref, rtol=stats_rtol,
                atol=stats_rtol * float(np.abs(ref).max()), err_msg=k)
            checked += 1
    assert checked == 2 * sum(1 for k in expect if k.endswith("running_mean"))


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("name", ["ResNet50", "ResNet18"])
def test_eval_mode_logits(name, precision):
    jdt, tdt, ndt, rtol, atol, _ = PRECISIONS[precision]
    model, params, stats = _flax_model(name, jdt)
    x = _images(dtype=ndt)
    # give the running statistics non-trivial values first
    _, new_state = model.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x * 2 + 1), train=True,
                               mutable=["batch_stats"])
    stats = _to_numpy(new_state["batch_stats"])
    logits = model.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), train=False)
    net = _torch_model(name, params, stats, tdt).eval()
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(logits), rtol=rtol,
                               atol=atol)


def test_same_padding_of_the_stride2_conv():
    """A stride-2 3x3 conv on an even input pads (0, 1) like Flax 'SAME',
    and (1, 1) on an odd one."""
    assert resnet._same_pads(8, 3, 2) == (0, 1)
    assert resnet._same_pads(7, 3, 2) == (1, 1)
    assert resnet._same_pads(8, 1, 2) == (0, 0)
    assert resnet._same_pads(8, 3, 1) == (1, 1)


def test_seeded_init_is_reproducible():
    a = resnet.ResNet18(num_filters=8, num_classes=10, seed=5)
    b = resnet.ResNet18(num_filters=8, num_classes=10, seed=5)
    c = resnet.ResNet18(num_filters=8, num_classes=10, seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_init.weight"], sc["conv_init.weight"])
