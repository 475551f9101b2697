"""The port's process-model surface beyond init and ranks
(``horovod_tpu_torch/basics.py``): the build and runtime probes, the
homogeneity fact from ``HVD_UNIFORM_LOCAL_SIZE``, the logging knobs,
``init(ranks=...)`` and the shutdown hooks, beside the reference's."""

import logging

import pytest
import torch.distributed as dist

import horovod_tpu as ref_hvd
import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics

PROBES = ["mpi_built", "gloo_built", "nccl_built", "ddl_built", "mlsl_built",
          "xla_built", "mpi_enabled", "gloo_enabled", "is_homogeneous",
          "mpi_threads_supported"]


@pytest.fixture(autouse=True)
def _cpu_init():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("name", PROBES + ["register_shutdown_hook"])
def test_the_reference_top_level_probes_are_exported(name):
    assert hasattr(ref_hvd, name) or name == "register_shutdown_hook"
    assert callable(getattr(hvd, name)) and name in hvd.__all__


def test_build_probes_tell_the_truth_about_the_port():
    assert hvd.gloo_built() == dist.is_gloo_available()
    assert hvd.nccl_built() == dist.is_nccl_available()
    assert not hvd.xla_built()
    assert not any(getattr(hvd, p)() for p in (
        "mpi_built", "ddl_built", "mlsl_built", "mpi_enabled",
        "mpi_threads_supported"))
    # standalone: no process group, so gloo is not the backend in use
    assert hvd.backend() is None and not hvd.gloo_enabled()


@pytest.mark.parametrize("value,want", [
    (None, True), ("", True), ("0", False), ("4", True), ("1", True)])
def test_is_homogeneous_follows_the_launchers_fact(monkeypatch, value,
                                                   want):
    if value is None:
        monkeypatch.delenv("HVD_UNIFORM_LOCAL_SIZE", raising=False)
    else:
        monkeypatch.setenv("HVD_UNIFORM_LOCAL_SIZE", value)
    assert hvd.is_homogeneous() is want


def test_is_homogeneous_rejects_a_malformed_value(monkeypatch):
    monkeypatch.setenv("HVD_UNIFORM_LOCAL_SIZE", "two")
    with pytest.raises(ValueError, match="not an integer"):
        hvd.is_homogeneous()
    hvd.shutdown()
    with pytest.raises(hvd.NotInitializedError):
        hvd.is_homogeneous()


def test_log_level_and_hide_time_reach_the_ports_logger_only(monkeypatch):
    lg = logging.getLogger("horovod_tpu_torch")
    root = logging.getLogger()
    old = (lg.level, list(lg.handlers), root.level, list(root.handlers))
    try:
        lg.handlers[:] = []
        root.handlers[:] = []
        monkeypatch.setenv("HOROVOD_LOG_LEVEL", "ERROR")
        monkeypatch.setenv("HOROVOD_LOG_HIDE_TIME", "1")
        basics._setup_logging()
        assert lg.level == logging.ERROR
        assert root.level == old[2]
        assert len(lg.handlers) == 1
        assert "asctime" not in lg.handlers[0].formatter._fmt
        monkeypatch.setenv("HOROVOD_LOG_LEVEL", "TRACE")  # maps to DEBUG
        basics._setup_logging()
        assert lg.level == logging.DEBUG and len(lg.handlers) == 1
        monkeypatch.setenv("HOROVOD_LOG_LEVEL", "bogus")  # ignored
        basics._setup_logging()
        assert lg.level == logging.DEBUG
        # the application's handler wins: none is added beside it
        lg.handlers[:] = []
        root.addHandler(logging.NullHandler())
        basics._setup_logging()
        assert lg.handlers == []
    finally:
        lg.setLevel(old[0])
        lg.handlers[:] = old[1]
        root.setLevel(old[2])
        root.handlers[:] = old[3]


def test_init_accepts_ranks_for_parity():
    hvd.shutdown()
    hvd.init([0], device="cpu")
    assert hvd.is_initialized() and (hvd.rank(), hvd.size()) == (0, 1)


def test_shutdown_hooks_run_and_replace_by_name():
    calls = []

    def hook():
        calls.append("first")

    basics.register_shutdown_hook(hook)
    first_count = len(basics._shutdown_hooks)

    def hook():  # noqa: F811  (same qualified name: replaces the first)
        calls.append("second")

    basics.register_shutdown_hook(hook)
    try:
        assert len(basics._shutdown_hooks) == first_count
        hvd.shutdown()
        assert calls == ["second"]
    finally:
        basics._shutdown_hooks.remove(hook)
