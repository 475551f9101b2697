"""Shared HOROVOD_* env parsing (one definition of boolean truthiness, so
every knob accepts the same spellings)."""

import os


def env_on(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true")


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default
