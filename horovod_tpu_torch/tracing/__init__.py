"""The trace clock and the Chrome-trace writer behind ``HOROVOD_TIMELINE``
(copies of ``horovod_tpu/tracing/clock.py`` and the writer class of
``horovod_tpu/tracing/writer.py``). The cross-rank span store, its merge
and the analyzer are not ported yet."""
