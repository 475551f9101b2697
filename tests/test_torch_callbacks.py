"""The port's training-loop callbacks (``horovod_tpu_torch/callbacks.py``)
against the reference's (``horovod_tpu/callbacks.py``): the lr of every
epoch and batch of the schedules and the warmup equal the reference's (the
same arithmetic, so exactly), at world 1 in this process and at world 2
(the reference on its thread cluster, the port on one module-scoped
cluster of 2 gloo processes, ``tests/torch_data_workers.py``), and the
broadcast and metric-average callbacks on that cluster."""

import warnings

import numpy as np
import pytest

import horovod_tpu as ref_hvd
from horovod_tpu import callbacks as ref_cb
from horovod_tpu import testing as ref_testing
import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as cb
from horovod_tpu_torch import testing
from torch_data_workers import callbacks_worker

SEED = 7


@pytest.fixture(scope="module")
def port_ranks():
    return testing.run_cluster(callbacks_worker, np=2, device="cpu",
                               args=(SEED,), timeout=300)


def _drive(callback, epochs, batches, lr=0.1, state_extra=None):
    """The lr in force at each batch of ``epochs`` x ``batches``."""
    state = {"lr": lr, **(state_extra or {})}
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for e in range(epochs):
            callback.on_epoch_begin(e, state)
            for b in range(batches):
                seen.append(state["lr"])
                callback.on_batch_end(b, state)
    return seen


SCHEDULES = {
    "staircase": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 0.1 ** (e // 2), staircase=True,
        initial_lr=1.0),
    "smooth": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        initial_lr=1.0, steps_per_epoch=4),
    "smooth_learned_steps": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        initial_lr=1.0),
    "constant_in_range": lambda m: m.LearningRateScheduleCallback(
        multiplier=0.5, start_epoch=1, end_epoch=3),
    "warmup": lambda m: m.LearningRateWarmupCallback(
        warmup_epochs=3, initial_lr=0.1, steps_per_epoch=4),
    "warmup_learned_steps": lambda m: m.LearningRateWarmupCallback(
        warmup_epochs=2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_lrs_equal_the_reference_at_world_1(name):
    got = _drive(SCHEDULES[name](cb), epochs=5, batches=4)
    want = _drive(SCHEDULES[name](ref_cb), epochs=5, batches=4)
    assert got == want


def test_smooth_schedule_warns_once_then_learns_the_steps():
    c = cb.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        initial_lr=1.0)
    state = {"lr": 1.0}
    c.on_epoch_begin(0, state)
    with pytest.warns(UserWarning, match="steps_per_epoch"):
        c.on_batch_end(0, state)
    c.on_batch_end(1, state)
    assert state["lr"] == 1.0  # held during epoch 0
    c.on_epoch_begin(1, state)
    c.on_batch_end(0, state)  # learned 2 steps: the fractional epoch 1.5
    assert state["lr"] == pytest.approx(1.0 / 2.5)
    state2 = {"lr": 1.0, "steps_per_epoch": 2}
    c2 = cb.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        initial_lr=1.0)
    c2.on_epoch_begin(0, state2)
    c2.on_batch_end(0, state2)
    assert state2["lr"] == pytest.approx(1.0 / 1.5)
    with pytest.raises(ValueError, match="lr"):
        cb.LearningRateScheduleCallback(multiplier=1.0).on_epoch_begin(0, {})


def _ref_warmup_lrs():
    c = ref_cb.LearningRateWarmupCallback(warmup_epochs=2, steps_per_epoch=3)
    state = {"lr": 0.1}
    seen = []
    for e in range(3):
        c.on_epoch_begin(e, state)
        for b in range(3):
            seen.append(state["lr"])
            c.on_batch_end(b, state)
    return seen


def test_warmup_lrs_equal_the_reference_at_world_2(port_ranks):
    want = ref_testing.run_cluster(_ref_warmup_lrs, np=2)
    ref_hvd.shutdown()
    assert want[0] == want[1]
    for r in port_ranks:
        assert r["lrs"] == want[0]
    # the formula: lr * (size * p + 1 - p) at p = fractional epoch / 2
    frac = [0.0, 1 / 3, 2 / 3, 1.0, 4 / 3, 5 / 3, 2.0, 2.0, 2.0]
    np.testing.assert_allclose(
        port_ranks[0]["lrs"],
        [0.1 * (2 * min(f / 2, 1) + 1 - min(f / 2, 1)) for f in frac],
        rtol=1e-12)


def test_broadcast_callback_takes_the_roots_parameters_and_state(
        port_ranks):
    r0, r1 = port_ranks
    assert any(not np.array_equal(r0["before"][k], r1["before"][k])
               for k in r0["before"])
    for r in port_ranks:
        for k, v in r1["before"].items():
            np.testing.assert_array_equal(r["params"][k], v)
    # momentum buffers broadcast too, then the same on both ranks
    for a, b in zip(r0["momentum"], r1["momentum"]):
        np.testing.assert_array_equal(a, b)


def test_metric_average_callback(port_ranks):
    for epoch in range(3):
        for r in port_ranks:
            m = r["metrics"][epoch]
            assert m["loss"] == 0.5 + epoch
            assert m["acc"] == 5.0


def test_metric_average_is_a_no_op_at_world_1_and_callback_list_dispatches():
    hvd.init(device="cpu")
    try:
        m = {"loss": 3.0}
        calls = []

        class Probe(cb.Callback):
            def on_train_begin(self, state):
                calls.append("train")

            def on_epoch_begin(self, epoch, state):
                calls.append(("begin", epoch))

            def on_batch_end(self, batch, state):
                calls.append(("batch", batch))

            def on_epoch_end(self, epoch, state, metrics=None):
                calls.append(("end", epoch, dict(metrics)))

        lst = cb.CallbackList([cb.MetricAverageCallback(), Probe()])
        lst.on_train_begin({})
        lst.on_epoch_begin(0, {})
        lst.on_batch_end(0, {})
        lst.on_epoch_end(0, {}, m)
        assert m == {"loss": 3.0}
        assert calls == ["train", ("begin", 0), ("batch", 0),
                         ("end", 0, {"loss": 3.0})]
    finally:
        hvd.shutdown()
