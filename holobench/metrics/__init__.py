"""Per-layer metrics, one module each, named as in ``BENCHMARK.json``:
``read(record) -> float or None``, ``None`` where the traced run holds
nothing to read (the harness then leaves the metric out of its line).

The record of a traced run (``holobench.harness``):

- ``device_ops``: ``[name, category, start_us, dur_us, glue]`` of every
  device operation in the profiled requests (``holobench.devtrace``);
- ``busy_s``, ``window_s``: the union of device work over the profiled
  requests, and their span from the first's start to the last's end;
- ``iterations``: the optimizer iterations of the profiled requests;
- ``spans_ms``: ``name -> [ms, ...]`` of the host spans (``prep``,
  ``optimize``, ``readback``) of every request of the traced window, each
  ended by a device synchronisation;
- ``work``: ``{"flops", "bytes"}`` of one iteration (``holobench.work``);
- ``peaks``: ``{"flops", "bytes_per_s"}`` of the device
  (``holobench.peaks``).
"""
