"""The port's VGG, Inception V3 and MNIST nets (``horovod_tpu_torch/models``)
against the reference's Flax models, on the same parameters carried by
``models/convert.py``, and their generalised ``Conv`` against Flax's.

Sizes: VGG with a short cfg at 64x64 (five pools leave 2 x 2 x 32, so the
first dense layer sees a spatial extent over 1 x 1 and an NCHW flatten
would permute its inputs; at 32x32 both orders agree), the MNIST nets at
28x28, Inception V3 at 139x139, batch 2, 10 classes. Dropout is 0 (VGG) or
off (the MNIST nets in eval): the port's masks come from its own
generators and cannot match JAX's bits.

Tolerances:
* VGG and the MNIST nets in f32: logits to 1e-4 of the largest |logit|,
  each gradient to 1e-3 of its tensor's largest |g| (measured up to 7.1e-7
  and 1.3e-6: the frameworks sum in other orders).
* Inception V3 in f64: logits to 1e-6 of the largest |logit|, gradients to
  1e-6 of each tensor's largest |g| (measured 0 and 6.1e-8: both models
  cast the logits to f32), running statistics after the training step to
  1e-6 (measured 5.5e-8). In f32 the last-bit differences of the two frameworks' conv sums
  pass through ~94 BatchNorms over batch 2, whose last blocks normalise 18
  values a channel, and grow to a large share of some tensors' largest
  |g|, so f32 cannot hold the structure to a useful bound.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import inception as ref_inception
from horovod_tpu.models import mnist as ref_mnist
from horovod_tpu.models import vgg as ref_vgg
from horovod_tpu_torch import models
from horovod_tpu_torch.models import inception, mnist, resnet, vgg
from horovod_tpu_torch.models.convert import (inception_state_dict_from_flax,
                                              mnist_state_dict_from_flax,
                                              vgg_state_dict_from_flax)

SHORT_CFG = [8, "M", 16, "M", 32, "M", 32, "M", 32, "M"]
LOGIT_REL, GRAD_REL = 1e-4, 1e-3
F64_REL = 1e-6
CLASSES = 10


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch ops
    from taking every core from the tests beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _images(n, side, channels, dtype=np.float32):
    return np.random.RandomState(0).randn(n, side, side, channels).astype(
        dtype)


def _labels(n):
    return np.arange(n) % CLASSES


# name -> (Flax model, torch constructor, converter, side, channels, Flax
# train)
SEQUENTIAL = {
    "vgg": (lambda: ref_vgg.VGG(cfg=SHORT_CFG, num_classes=CLASSES,
                                dtype=jnp.float32, dropout=0.0),
            lambda: vgg.VGG(SHORT_CFG, num_classes=CLASSES, dropout=0.0,
                            image_size=64),
            vgg_state_dict_from_flax, 64, 3, True),
    "mnist_conv": (lambda: ref_mnist.MNISTConvNet(num_classes=CLASSES),
                   lambda: mnist.MNISTConvNet(num_classes=CLASSES),
                   mnist_state_dict_from_flax, 28, 1, False),
    "mnist_mlp": (lambda: ref_mnist.MNISTMLP(num_classes=CLASSES),
                  lambda: mnist.MNISTMLP(num_classes=CLASSES),
                  mnist_state_dict_from_flax, 28, 1, False),
}


@functools.lru_cache(maxsize=None)
def _sequential_reference(name):
    """(logits, params, grads) of the Flax model as numpy, from one
    compiled value-and-grad of the softmax cross entropy."""
    make, _, _, side, ch, train = SEQUENTIAL[name]
    model = make()
    x, y = _images(2, side, ch), _labels(2)
    params = _np(model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            train=False)["params"])

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(x), train=train)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return np.asarray(logits), params, _np(grads)


def _sequential_port(name, params):
    _, build, convert, _, _, train = SEQUENTIAL[name]
    net = build()
    net.load_state_dict(convert(params), strict=True)
    return net.train(train)


@pytest.mark.parametrize("name", list(SEQUENTIAL))
def test_converted_state_dict_covers_the_model(name):
    _, params, _ = _sequential_reference(name)
    convert = SEQUENTIAL[name][2]
    sd = convert(params)
    want = SEQUENTIAL[name][1]().state_dict()
    assert sorted(sd) == sorted(want)
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in want.items())
    assert sum(v.numel() for v in sd.values()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))
    with pytest.raises(KeyError, match="unknown Flax"):
        convert({**params, "BatchNorm_0": {"scale": np.ones(3)}})


@pytest.mark.parametrize("name", list(SEQUENTIAL))
def test_logits_and_gradients_match_flax(name):
    logits, params, grads = _sequential_reference(name)
    net = _sequential_port(name, params)
    x, y = _images(2, *SEQUENTIAL[name][3:5]), _labels(2)
    out = net(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, CLASSES)
    assert _max_rel(out.detach().numpy(), logits) <= LOGIT_REL
    F.cross_entropy(out, torch.from_numpy(y)).backward()
    want = SEQUENTIAL[name][2](grads)
    for k, p in net.named_parameters():
        assert _max_rel(p.grad.numpy(), want[k].numpy()) <= GRAD_REL, k


def _nchw_flatten_logits(net, x):
    """The port's VGG with the flatten in NCHW order, (c, h, w)."""
    h = x.permute(0, 3, 1, 2)
    convs = iter(net.convs)
    for v in net.cfg:
        h = F.max_pool2d(h, 2, 2) if v == "M" else F.relu(next(convs)(h))
    h = h.flatten(1)
    for dense in net.dense[:-1]:
        h = F.relu(dense(h))
    return net.dense[-1](h)


def test_an_nchw_flatten_fails_the_comparison():
    """At 64x64 the first dense layer sees 2 x 2 x 32 inputs: the Flax
    order (h, w, c) agrees with the reference, the NCHW order does not, so
    the logit comparison above would catch it."""
    logits, params, _ = _sequential_reference("vgg")
    net = _sequential_port("vgg", params)
    x = torch.from_numpy(_images(2, 64, 3))
    with torch.no_grad():
        assert _max_rel(net(x).numpy(), logits) <= LOGIT_REL
        assert _max_rel(_nchw_flatten_logits(net, x).numpy(),
                        logits) > 100 * LOGIT_REL


@functools.lru_cache(maxsize=None)
def _inception_shapes():
    """The Flax Inception V3's variables as shapes (``jax.eval_shape`` of
    its init: no initializer runs)."""
    model = ref_inception.InceptionV3(num_classes=CLASSES,
                                      dtype=jnp.float64)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 139, 139, 3)), train=True))


@functools.lru_cache(maxsize=None)
def _inception_reference():
    """Flax Inception V3 in f64 at 139x139, batch 2: (logits, params,
    batch_stats, grads, new batch_stats), numpy. The variables are drawn
    here in the Flax tree's shapes (LeCun-normal kernels; random BN scales,
    biases and running statistics, so that no branch hides behind ones and
    zeros), as f32 values, since the Flax model's parameters are f32
    (``param_dtype``) whatever its compute dtype."""
    model = ref_inception.InceptionV3(num_classes=CLASSES,
                                      dtype=jnp.float64)
    x, y = _images(2, 139, 3, np.float64), _labels(2)
    rng = np.random.RandomState(3)

    def draw(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif key in ("scale", "var"):
            a = 1 + 0.2 * rng.rand(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32).astype(np.float64)

    shapes = _inception_shapes()
    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])

    def loss(p):
        logits, new = model.apply({"params": p, "batch_stats": stats},
                                  jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), (logits, new["batch_stats"])

    (_, (logits, new)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return (np.asarray(logits), params, stats, _np(grads, np.float64),
            _np(new, np.float64))


def test_inception_state_dict_names_and_unknown_names():
    _, params, stats, _, _ = _inception_reference()
    sd = inception_state_dict_from_flax(params, stats)
    net = inception.InceptionV3(num_classes=CLASSES)
    want = net.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in want.items())
    assert "InceptionB_3.ConvBN_8.conv.weight" in sd
    assert tuple(sd["InceptionB_3.ConvBN_8.conv.weight"].shape) == (
        192, 192, 1, 7)
    with pytest.raises(KeyError, match="unknown Flax"):
        inception_state_dict_from_flax({**params, "Conv_9": {}}, stats)
    with pytest.raises(KeyError, match="unknown Flax"):
        inception_state_dict_from_flax(
            {"ConvBN_0": {"Conv_0": {"kernel": np.zeros((3, 3, 3, 32)),
                                     "lora": np.zeros(3)}}}, {})


def test_inception_logits_gradients_and_running_stats():
    logits, params, stats, grads, new_stats = _inception_reference()
    net = inception.InceptionV3(num_classes=CLASSES)
    net.load_state_dict(inception_state_dict_from_flax(params, stats),
                        strict=True)
    net = net.double().train()
    x, y = _images(2, 139, 3, np.float64), _labels(2)
    out = net(torch.from_numpy(x))
    assert out.dtype == torch.float32
    assert _max_rel(out.detach().numpy(), logits) <= F64_REL
    F.cross_entropy(out, torch.from_numpy(y)).backward()
    want = inception_state_dict_from_flax(grads, {})
    for k, p in net.named_parameters():
        assert _max_rel(p.grad.numpy(), want[k].numpy()) <= F64_REL, k
    expect = inception_state_dict_from_flax(params, new_stats)
    got = net.state_dict()
    running = [k for k in expect if "running" in k]
    assert len(running) == 2 * 94
    for k in running:
        assert _max_rel(got[k].numpy(), expect[k].numpy()) <= F64_REL, k


def test_same_average_pool_counts_the_padding():
    """Inception's 3x3 stride-1 'SAME' average: border pixels divide by 9
    (the padding counts, Flax's default), a corner sums 4 values."""
    x = _images(2, 7, 5)
    want = np.asarray(nn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                                  padding="SAME"))
    got = inception._avg_pool_same(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, 0, 0], x[:, :2, :2].sum((1, 2)) / 9,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel,stride,padding,bias,side", [
    ((1, 7), 1, "SAME", False, 9), ((7, 1), 1, "SAME", False, 9),
    ((1, 3), 1, "SAME", False, 8), ((3, 3), 2, "VALID", False, 17),
    ((3, 3), 2, "SAME", True, 8), ((5, 5), 1, "SAME", False, 7),
    ((3, 3), 1, "VALID", True, 9)])
def test_conv_matches_flax(kernel, stride, padding, bias, side):
    """The generalised Conv: rectangular kernels, strides, Flax's 'SAME'
    (asymmetric on an even input at stride 2) and 'VALID', with or
    without a bias."""
    x = _images(2, side, 4)
    conv = nn.Conv(6, kernel, (stride, stride), padding=padding,
                   use_bias=bias, dtype=jnp.float32)
    params = _np(conv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    if bias:
        params["bias"] = np.random.RandomState(2).randn(6).astype(np.float32)
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = resnet.Conv(4, 6, kernel, stride, padding, bias=bias)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            params["kernel"].transpose(3, 2, 0, 1).copy()))
        if bias:
            port.bias.copy_(torch.from_numpy(params["bias"]))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def _flax_count(model, side, channels=3):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, channels)),
        train=False))
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name,port,want", [
    ("VGG16", lambda: models.VGG16(), 138_357_544),
    ("VGG19", lambda: models.VGG19(), 143_667_240),
    ("InceptionV3", lambda: models.InceptionV3(), None),
    ("MNISTConvNet", lambda: mnist.MNISTConvNet(), None),
    ("MNISTMLP", lambda: mnist.MNISTMLP(), None)])
def test_parameter_counts(name, port, want):
    n = sum(p.numel() for p in port().parameters())
    if want is not None:
        assert n == want
    if name == "InceptionV3":
        assert 23.0e6 < n < 24.5e6, n
        # the head follows a global mean: the count is the input size's
        assert n == sum(int(np.prod(a.shape)) for a in
                        jax.tree_util.tree_leaves(
                            _inception_shapes()["params"])) - 2048 * (
            CLASSES - 1000) - (CLASSES - 1000)
    if name.startswith("MNIST"):
        assert n == _flax_count(getattr(ref_mnist, name)(), 28, 1)


def test_models_package_exports_the_reference_names():
    import horovod_tpu.models as ref_models

    assert sorted(models.__all__) == sorted(ref_models.__all__)
    assert all(callable(getattr(models, n)) for n in models.__all__)
    assert mnist.MNISTConvNet and mnist.MNISTMLP


def test_dropout_is_seeded_and_off_in_eval():
    x = torch.ones(4, 28, 28, 1)
    a, b = mnist.MNISTConvNet(seed=3), mnist.MNISTConvNet(seed=3)
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)  # same weights, same masks
    assert not torch.equal(ya, a(x))  # the generator moved on
    a.eval()
    assert torch.equal(a(x), a(x))
    drop = vgg.Dropout(0.25, vgg.DropoutRNG(0)).train()
    y = drop(torch.ones(100_000))
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    with pytest.raises(ValueError, match="dropout rate"):
        vgg.Dropout(1.0, vgg.DropoutRNG(0))


@pytest.mark.parametrize("build", [
    lambda s: vgg.VGG(SHORT_CFG, num_classes=CLASSES, image_size=64, seed=s),
    lambda s: inception.InceptionV3(num_classes=CLASSES, seed=s),
    lambda s: mnist.MNISTConvNet(seed=s)])
def test_seeded_init_is_reproducible(build):
    sa, sb, sc = (build(s).state_dict() for s in (5, 5, 6))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert any(not torch.equal(sa[k], sc[k]) for k in sa)


def test_image_models_by_name_and_their_knobs():
    from horovod_tpu_torch import train

    assert sorted(train.IMAGE_MODELS) == sorted(
        [n for n in models.__all__ if n not in ("ResNet", "TransformerLM",
                                                "VGG")]
        + ["MNISTConvNet", "MNISTMLP"])
    net = train.image_model("MNISTConvNet", num_classes=7, image=28)
    assert net(torch.zeros(1, 28, 28, 1)).shape == (1, 7)
    assert train.has_dropout(net)
    assert not train.has_dropout(mnist.MNISTConvNet(dropout=(0.0, 0.0)))
    assert not train.has_dropout(train.image_model("MNISTMLP"))
    with pytest.raises(ValueError, match="num_filters"):
        train.image_model("MNISTMLP", num_filters=8)
    with pytest.raises(ValueError, match="expected one of"):
        train.image_model("AlexNet")


def test_a_compiled_step_with_dropout_runs_eagerly():
    """A graph cannot replay the model's own dropout generator: the
    compiled plane runs such a model eagerly, and refuses graph=True."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train

    try:
        res = train.synthetic_train("MNISTConvNet", batch=2, image=28,
                                    steps=1, warmup=1, device="cpu",
                                    num_classes=10, plane="compiled")
        assert res["graphed"] is False
        assert all(np.isfinite(res["losses"]))
        with pytest.raises(ValueError, match="dropout"):
            train.ImageTrainer("MNISTConvNet", batch=2, image=28,
                               device="cpu", plane="compiled", graph=True)
    finally:
        hvd.shutdown()
